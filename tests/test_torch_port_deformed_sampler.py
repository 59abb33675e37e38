"""Port: the DynamicFocus deformed sampler (``core/deformed_sampler.py``), the
gaze maps (``core/gaze.py``) and ``core/interpolate.py::resize_1d`` against
the JAX package on the same seeded numpy inputs, at the sizes of
``tests/test_deformed_sampler.py`` (a 12x12 sample, kernel 7).

* ``get_grid`` within rtol 1e-5 / atol 1e-6 (matrix products summed in
  another order);
* ``int_round_scale_grid`` equal, inputs on integer boundaries included;
* ``deformed_unsampler``: the scatter's winners equal to JAX's; the hole
  fill's indices bit-equal to ``nearest_seed_pallas(..., interpret=True)``
  (the TPU's route) on the same mask, and the output equal to the values
  gathered there; the output equal to the JAX function's on every pixel
  whose nearest landed pixel is unique (the JAX function's CPU lax chain
  breaks equidistant ties otherwise, ROADMAP.md queue 3);
* the gaze maps and ``resize_1d`` within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_torch.core import deformed_sampler as T
from fovealseg_torch.core import gaze as tgaze
from fovealseg_torch.core.interpolate import resize_1d
from fovealseg_torch.ops.jfa import nearest_seed
from fovealseg_tpu.core import deformed_sampler as J
from fovealseg_tpu.core import gaze as jgaze
from fovealseg_tpu.core import interpolate as jinterp
from fovealseg_tpu.ops.pallas_jfa import nearest_seed_pallas

HS = WS = 12
K = 7
CANVAS = (40, 36)


def _dm(rng, b=2):
    pad = K // 2
    return rng.uniform(0, 1, (b, HS + 2 * pad, WS + 2 * pad, 1)).astype(np.float32)


def test_get_grid_against_jax(rng):
    dm = _dm(rng)
    ours = T.get_grid(torch.from_numpy(dm), (HS, WS), kernel_size=K).numpy()
    ref = np.asarray(J.get_grid(jnp.asarray(dm), (HS, WS), kernel_size=K))
    assert ours.shape == ref.shape == (2, HS, WS, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(T.gaussian_kernel_1d(K, K // 2), J.gaussian_kernel_1d(K, K // 2))
    with pytest.raises(ValueError):
        T.get_grid(torch.from_numpy(dm), (HS + 1, WS), kernel_size=K)


def test_int_round_scale_grid_against_jax(rng):
    h, w = CANVAS
    random = rng.uniform(-1.2, 1.2, (2, HS, WS, 2)).astype(np.float32)
    # grid values whose canvas coordinate is an integer, as f32 computes it
    rows = (2.0 * np.arange(h, dtype=np.float32) / np.float32(h - 1) - 1.0).astype(np.float32)
    cols = (2.0 * np.arange(w, dtype=np.float32) / np.float32(w - 1) - 1.0).astype(np.float32)
    n = min(h, w)
    boundary = np.stack([rows[:n], cols[:n]], axis=-1)[None, None]
    for g in (random, boundary, np.float32([[[[-1.0, 1.0], [0.0, 0.0]]]])):
        ours = T.int_round_scale_grid(torch.from_numpy(g), CANVAS).numpy()
        ref = np.asarray(J.int_round_scale_grid(jnp.asarray(g), CANVAS))
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)


def _unique_nearest(hit: np.ndarray) -> np.ndarray:
    """[B, H, W] bool: the pixel's nearest landed pixel is unique."""
    b, h, w = hit.shape
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros_like(hit)
    for i in range(b):
        sy, sx = np.nonzero(hit[i])
        d = (yy[..., None] - sy) ** 2 + (xx[..., None] - sx) ** 2
        out[i] = (d == d.min(-1, keepdims=True)).sum(-1) == 1
    return out


def test_deformed_unsampler_against_jax(rng):
    dm = _dm(rng)
    grid = np.asarray(J.get_grid(jnp.asarray(dm), (HS, WS), kernel_size=K))
    ig = np.array(J.int_round_scale_grid(jnp.asarray(grid), CANVAS))
    # collisions too: a few samples sent to one pixel
    ig[:, 0, :4] = ig[:, 0, :1]
    h, w = CANVAS
    values = rng.standard_normal((2, HS, WS, 3)).astype(np.float32)

    # the scatter's winners: the source index carried as the value
    src = np.arange(HS * WS, dtype=np.float32).reshape(1, HS, WS, 1).repeat(2, 0)
    win_t = T.deformed_unsampler(torch.from_numpy(src), torch.from_numpy(ig), CANVAS).numpy()
    win_j = np.asarray(J.deformed_unsampler(jnp.asarray(src), jnp.asarray(ig), CANVAS))
    hit = np.zeros((2, h, w), bool)
    for i in range(2):
        hit[i, ig[i, ..., 0], ig[i, ..., 1]] = True
    assert hit.sum() < hit.size // 4  # holes to fill
    np.testing.assert_array_equal(win_t[hit], win_j[hit])
    assert len(np.unique(win_t[0][hit[0]])) == hit[0].sum()

    ours = T.deformed_unsampler(torch.from_numpy(values), torch.from_numpy(ig), CANVAS).numpy()
    idx_pallas = np.asarray(nearest_seed_pallas(jnp.asarray(hit), interpret=True))
    idx_port = nearest_seed(torch.from_numpy(hit)).numpy()
    np.testing.assert_array_equal(idx_port, idx_pallas)
    # the landed canvas (each hit pixel's winner's values), gathered at the fill indices
    flat_win = win_t.reshape(2, h * w).astype(np.int64)
    landed = values.reshape(2, HS * WS, 3)[np.arange(2)[:, None], flat_win]
    expect = landed[np.arange(2)[:, None], idx_pallas.reshape(2, h * w)].reshape(2, h, w, 3)
    np.testing.assert_array_equal(ours, expect)

    ref = np.asarray(J.deformed_unsampler(jnp.asarray(values), jnp.asarray(ig), CANVAS))
    unique = _unique_nearest(hit)
    assert unique.mean() > 0.8
    np.testing.assert_array_equal(ours[unique], ref[unique])


def test_gaze_maps_and_resize_1d_against_jax(rng):
    fp = rng.uniform(0, 1, (3, 2)).astype(np.float32)
    t, j = torch.from_numpy(fp), jnp.asarray(fp)
    for h, w in ((17, 23), (64, 64)):
        rows_t, cols_t = tgaze.grid_coords(h, w)
        rows_j, cols_j = jgaze.grid_coords(h, w)
        np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
        np.testing.assert_array_equal(cols_t.numpy(), np.asarray(cols_j))
        cases = ((tgaze.focus_distance_map(t, h, w), jgaze.focus_distance_map(j, h, w)),
                 (tgaze.focus_gaussian_map(t, h, w), jgaze.focus_gaussian_map(j, h, w)),
                 (tgaze.focus_gaussian_map(t, h, w, std=8.0),
                  jgaze.focus_gaussian_map(j, h, w, std=8.0)),
                 (tgaze.cosine_decay_map(t, h, w), jgaze.cosine_decay_map(j, h, w)),
                 (tgaze.cosine_decay_map(t, h, w, radius=6.0, max_value=1.0, min_value=0.1),
                  jgaze.cosine_decay_map(j, h, w, radius=6.0, max_value=1.0, min_value=0.1)))
        for ours, ref in cases:
            assert ours.shape == (3, h, w, 1) and ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    v = rng.standard_normal(45).astype(np.float32)
    for out in (91, 45, 20, 1):
        np.testing.assert_allclose(resize_1d(torch.from_numpy(v), out).numpy(),
                                   np.asarray(jinterp.resize_1d(jnp.asarray(v), out)),
                                   rtol=1e-6, atol=1e-6)
