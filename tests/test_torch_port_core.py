"""Port: core geometry against the JAX package (f32 on the CPU).

Tolerances: float results within 1e-5 absolute (1e-6 for the half-pixel
average, a fixed sum of four terms); the JAX package contracts with dense
resize matrices and XLA orders sums its own way, so the last bits differ.
Integer results (landing scatter, inverse index, round counts, labels) are
compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import gaze as jgaze
from fovealseg_tpu.core import grid as jgrid
from fovealseg_tpu.core import interpolate as jinterp
from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.core import warp as jwarp
from fovealseg_tpu.ops.pallas_jfa import nearest_class_pallas
from fovealseg_torch.core import gaze, grid, interpolate, unwarp, warp


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _saliency(seed, shape):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, shape).astype(np.float32) ** 4
    return (s / s.sum(axis=(1, 2, 3), keepdims=True)).astype(np.float32)


def _grid(seed, task=(16, 16), sal=(16, 16), radius=5):
    solver = jgrid.GridSolver(sal[0], sal[1], radius, radius * (sal[1] // sal[0]), float(radius))
    xs = jgrid.pad_saliency(jnp.asarray(_saliency(seed, (2, *sal, 1))), solver.pad_x, solver.pad_y)
    g, _ = solver.create_grid(xs, task)
    return _np(g)


def test_focus_distance_map():
    f = np.random.default_rng(0).uniform(0, 1, (3, 2)).astype(np.float32)
    ref = _np(jgaze.focus_distance_map(jnp.asarray(f), 20, 36))
    got = gaze.focus_distance_map(_t(f), 20, 36).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_linear_resize_matrix_is_the_same():
    for n_in, n_out in [(640, 80), (10, 80), (91, 181), (1, 5)]:
        np.testing.assert_array_equal(interpolate._linear_resize_matrix(n_in, n_out),
                                      jinterp._linear_resize_matrix(n_in, n_out))


@pytest.mark.parametrize("shape,out_hw", [((2, 64, 64, 3), (16, 16)), ((2, 10, 10, 2), (80, 80)),
                                          ((1, 48, 80, 5), (20, 24)), ((1, 16, 16, 2), (16, 16))])
def test_resize_bilinear(shape, out_hw):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = _np(jinterp.resize_bilinear(jnp.asarray(x), out_hw))
    got = interpolate.resize_bilinear(_t(x), out_hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["replication", "reflect", "zero"])
def test_pad_saliency(mode):
    xs = _saliency(2, (2, 16, 16, 1))
    ref = _np(jgrid.pad_saliency(jnp.asarray(xs), 5, 7, mode))
    np.testing.assert_array_equal(grid.pad_saliency(_t(xs), 5, 7, mode).numpy(), ref)


@pytest.mark.parametrize("sal,task,label,radius", [((16, 16), (16, 16), (16, 16), 5),
                                                   ((16, 32), (24, 40), (12, 20), 4),
                                                   ((80, 80), (80, 80), (80, 80), 45)])
def test_grid_solver_create_grid(sal, task, label, radius):
    js = jgrid.GridSolver(sal[0], sal[1], radius, radius * (sal[1] // sal[0]), float(radius))
    ts = grid.GridSolver(js.grid_h, js.grid_w, js.pad_x, js.pad_y, js.radius)
    xs = _saliency(3, (2, *sal, 1))
    xs_hm = jgrid.pad_saliency(jnp.asarray(xs), js.pad_x, js.pad_y)
    g_ref, gy_ref = js.create_grid(xs_hm, task, label)
    g, gy = ts.create_grid(grid.pad_saliency(_t(xs), ts.pad_x, ts.pad_y), task, label)
    np.testing.assert_allclose(g.numpy(), _np(g_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), _np(gy_ref), rtol=0, atol=1e-5)


def test_grid_sample_bilinear():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 24, 40, 3)).astype(np.float32)
    g = rng.uniform(-1.1, 1.1, (2, 9, 13, 2)).astype(np.float32)  # some taps off the image
    ref = _np(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(g)))
    got = warp.grid_sample(_t(img), _t(g)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [5, 6])
def test_landing_scatter_and_inverse_index_bit_equal(seed):
    g = _grid(seed)
    keys = np.random.default_rng(seed).integers(0, 2**24, (2, 256)).astype(np.int32)
    ref = _np(jgrid.landing_scatter_max(jnp.asarray(g), (64, 48), jnp.asarray(keys)))
    np.testing.assert_array_equal(grid.landing_scatter_max(_t(g), (64, 48), _t(keys)).numpy(), ref)
    idx_ref, valid_ref = jgrid.inverse_grid_index(jnp.asarray(g), (64, 64))
    idx, valid = grid.inverse_grid_index(_t(g), (64, 64))
    np.testing.assert_array_equal(idx.numpy(), _np(idx_ref))
    np.testing.assert_array_equal(valid.numpy(), _np(valid_ref))


def test_halfpixel_avg():
    p = np.random.default_rng(7).normal(size=(2, 16, 12, 51)).astype(np.float32)
    ref = _np(junwarp.halfpixel_avg(jnp.asarray(p)))
    np.testing.assert_allclose(unwarp.halfpixel_avg(_t(p)).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,seg_hw", [(8, (64, 64)), (9, (640, 640)), (10, (48, 80))])
def test_jfa_rounds_from_grid(seed, seg_hw):
    g = _grid(seed)
    ref = int(junwarp.jfa_rounds_from_grid(jnp.asarray(g), seg_hw))
    got = unwarp.jfa_rounds_from_grid(_t(g), seg_hw)
    assert got.dtype == torch.int32 and int(got) == ref


def _pred_grid(seed):
    pred = np.random.default_rng(seed).normal(size=(2, 16, 16, 51)).astype(np.float32)
    return pred, _grid(seed)


@pytest.mark.parametrize("seed", [11, 12])
def test_unwarp_argmax_scatter_runtime_rounds_bit_equal(seed):
    """With the grid-derived round count: bit-equal to the JAX composition
    landing_scatter_max -> nearest_class_pallas(interpret=True, rounds)."""
    pred, g = _pred_grid(seed)
    seg_hw = (64, 64)
    rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(g), seg_hw)
    m = 64
    cls2 = jnp.argmax(junwarp.halfpixel_avg(jnp.asarray(pred)), axis=-1).astype(jnp.int32)
    combined = jnp.arange(256, dtype=jnp.int32)[None] * m + cls2.reshape(2, 256)
    canvas = jgrid.landing_scatter_max(jnp.asarray(g), seg_hw, combined)
    valid = canvas >= 0
    ref = _np(nearest_class_pallas(valid, jnp.where(valid, canvas % m, 0), cls_bits=6,
                                   interpret=True, rounds=rounds))
    got = unwarp.unwarp_argmax_scatter(_t(pred), _t(g), seg_hw,
                                       rounds=unwarp.jfa_rounds_from_grid(_t(g), seg_hw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [13, 14])
def test_unwarp_argmax_scatter_full_rounds(seed):
    """Full chain: bit-equal to the Pallas composition at full rounds. The JAX
    function on the CPU runs the lax chain instead, which breaks ties between
    equidistant seeds differently (test_torch_port_jfa.py); with a random
    class on every task pixel such ties often carry different classes, so the
    labels agree on >= 97% of pixels here (>= 99.5% on model logits,
    test_torch_port_slice.py)."""
    pred, g = _pred_grid(seed)
    seg_hw = (64, 64)
    got = unwarp.unwarp_argmax_scatter(_t(pred), _t(g), seg_hw).numpy()
    m = 64
    cls2 = jnp.argmax(junwarp.halfpixel_avg(jnp.asarray(pred)), axis=-1).astype(jnp.int32)
    combined = jnp.arange(256, dtype=jnp.int32)[None] * m + cls2.reshape(2, 256)
    canvas = jgrid.landing_scatter_max(jnp.asarray(g), seg_hw, combined)
    valid = canvas >= 0
    pallas = _np(nearest_class_pallas(valid, jnp.where(valid, canvas % m, 0), cls_bits=6,
                                      interpret=True))
    np.testing.assert_array_equal(got, pallas)
    lax = _np(junwarp.unwarp_argmax_scatter(jnp.asarray(pred), jnp.asarray(g), seg_hw))
    assert (got == lax).mean() >= 0.97
