"""Port: the row gather's backward (K5b) against the JAX gradient, on the CPU.

``row_gather_backward_plain`` sums each table row's gradient rows in
ascending pixel order, one f32 chain from +0.0: the order of the JAX
package's own gradient of ``core/unwarp.py::_gather_rows_flat`` on the CPU
(its scatter-add). So every case here is held bit for bit
(``np.array_equal`` on the int32 views, no tolerance): the plain version,
``row_gather_backward`` on CPU tensors and ``row_gather``'s autograd
against ``jax.vjp`` of the flat gather, on numpy inputs from a seed.
Indices outside [0, T) are held against an explicit clamp (a sequential
``np.add.at``), not against JAX, whose flat gather sends such an index into
the neighbouring image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import grid as jgrid
from fovealseg_tpu.core.unwarp import _gather_rows_flat as jax_gather_rows_flat
from fovealseg_torch.core.grid import inverse_grid_index
from fovealseg_torch.core.unwarp import jfa_rounds_from_grid
from fovealseg_torch.ops.gather import row_gather, row_gather_backward, row_gather_backward_plain
from fovealseg_torch.ops.jfa import nearest_payload_packed_plain


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_grad(idx: np.ndarray, w: np.ndarray, t: int) -> np.ndarray:
    """``jax.vjp`` of the flat gather at a [B, T, C] table, cotangent w."""
    b, c = idx.shape[0], w.shape[-1]
    table = jnp.zeros((b, t, c), jnp.float32)
    _, vjp = jax.vjp(lambda v: jax_gather_rows_flat(v, jnp.asarray(idx)), table)
    return np.asarray(vjp(jnp.asarray(w))[0])


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _hold(idx: np.ndarray, w: np.ndarray, t: int) -> None:
    """The plain version, the CPU wrapper and the CPU autograd, each
    bit-equal to the JAX gradient."""
    ref = _bits(_jax_grad(idx, w, t))
    gi, gw = torch.from_numpy(idx), torch.from_numpy(w)
    assert np.array_equal(_bits(row_gather_backward_plain(gw, gi, t)), ref)
    assert np.array_equal(_bits(row_gather_backward(gw, gi, t)), ref)
    table = torch.zeros((idx.shape[0], t, w.shape[-1]), requires_grad=True)
    (row_gather(table, gi) * gw).sum().backward()
    assert np.array_equal(_bits(table.grad), ref)


def _grads(rng, shape, spread=False) -> np.ndarray:
    w = rng.normal(size=shape).astype(np.float32)
    if spread:  # 16 orders of magnitude, and signed zeros
        w *= (10.0 ** rng.integers(-8, 8, shape)).astype(np.float32)
        w[rng.uniform(size=shape) < 0.1] = -0.0
        w[rng.uniform(size=shape) < 0.05] = 0.0
    return w


def _flood_indices(seed: int) -> np.ndarray:
    """K2's plain version on a 64x64 canvas over a 16x16 task: the task
    index of each canvas pixel's nearest landed seed, from a grid solved on
    a seeded saliency map."""
    rng = np.random.default_rng(seed)
    sal = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32) ** 4
    sal /= sal.sum(axis=(1, 2, 3), keepdims=True)
    solver = jgrid.GridSolver(16, 16, 5, 5, 5.0)
    xs = jgrid.pad_saliency(jnp.asarray(sal), solver.pad_x, solver.pad_y)
    g, _ = solver.create_grid(xs, (16, 16))
    g = torch.from_numpy(np.array(g))
    task_idx, valid = inverse_grid_index(g, (64, 64))
    rounds = jfa_rounds_from_grid(g, (64, 64))
    out = nearest_payload_packed_plain(valid, task_idx, 8, rounds)
    return out.reshape(2, -1).numpy().astype(np.int32)


@pytest.mark.parametrize("c", [1, 2, 3, 51])
def test_flood_indices(c):
    """Indices from the payload flood, as ``MODEL.loss_at_high_res``
    'nearest' gives them: ~16 canvas pixels per task row."""
    idx = _flood_indices(7)
    assert idx.min() >= 0 and idx.max() < 256 and len(np.unique(idx[0])) > 100
    _hold(idx, _grads(np.random.default_rng(c), (*idx.shape, c)), 256)


@pytest.mark.parametrize("b,t,n,c", [(2, 16, 300, 51), (3, 50, 1000, 1), (1, 7, 40, 3),
                                     (2, 1000, 4000, 2), (1, 3, 5000, 5)])
def test_random_in_range(b, t, n, c):
    rng = np.random.default_rng(b * t + n + c)
    idx = rng.integers(0, t, (b, n)).astype(np.int32)
    _hold(idx, _grads(rng, (b, n, c)), t)


@pytest.mark.parametrize("c", [1, 51])
def test_rows_no_pixel_reaches(c):
    """Most rows take no pixel (as in 'BI', where 98.5% do not): they are
    +0.0 in every channel."""
    rng = np.random.default_rng(11 + c)
    idx = (rng.integers(0, 20, (2, 500)) * 37).astype(np.int32)  # 20 of 740 rows
    got = row_gather_backward_plain(torch.from_numpy(_grads(rng, (2, 500, c))),
                                    torch.from_numpy(idx), 740)
    hit = np.zeros(740, bool)
    hit[np.unique(idx)] = True
    assert np.array_equal(_bits(got[:, ~hit]), np.zeros((2, (~hit).sum(), c), np.int32))
    _hold(idx, _grads(rng, (2, 500, c)), 740)


@pytest.mark.parametrize("c", [1, 3])
def test_one_row_takes_every_pixel(c):
    """One chain of 4000 adds, in pixel order."""
    rng = np.random.default_rng(5)
    idx = np.full((2, 4000), 3, np.int32)
    _hold(idx, _grads(rng, (2, 4000, c)), 9)


@pytest.mark.parametrize("c", [1, 2, 3, 51])
def test_magnitudes_and_signed_zeros(c):
    """Terms over 16 orders of magnitude, and +0.0 and -0.0 ones: the order
    of the adds decides the rounding, and a row of -0.0 terms sums to +0.0
    from its +0.0 start."""
    rng = np.random.default_rng(100 + c)
    idx = rng.integers(0, 30, (2, 2000)).astype(np.int32)
    w = _grads(rng, (2, 2000, c), spread=True)
    w[0, idx[0] == 4] = -0.0  # row 4 of image 0 takes only -0.0 terms
    _hold(idx, w, 30)
    got = row_gather_backward_plain(torch.from_numpy(w), torch.from_numpy(idx), 30)
    assert np.array_equal(_bits(got[0, 4]), np.zeros(c, np.int32))  # +0.0, not -0.0


@pytest.mark.parametrize("c", [1, 51])
def test_out_of_range_clamped(c):
    """Indices outside [0, T) count for rows 0 and T-1, in pixel order,
    as the forward clamps them; held against a sequential ``np.add.at``."""
    rng = np.random.default_rng(21)
    b, t, n = 3, 40, 900
    idx = rng.integers(-10, t + 10, (b, n)).astype(np.int32)
    w = _grads(rng, (b, n, c), spread=True)
    ref = np.zeros((b * t, c), np.float32)
    np.add.at(ref, (np.clip(idx, 0, t - 1) + np.arange(b)[:, None] * t).reshape(-1),
              w.reshape(-1, c))
    got = row_gather_backward_plain(torch.from_numpy(w), torch.from_numpy(idx), t)
    assert np.array_equal(_bits(got), _bits(ref.reshape(b, t, c)))


def test_index_map_of_any_rank():
    """idx [B, H, W] and grad_out [B, H, W, C], as the inverse warp passes
    them."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 12, (2, 9, 7)).astype(np.int32)
    w = _grads(rng, (2, 9, 7, 4))
    ref = _bits(_jax_grad(idx.reshape(2, -1), w.reshape(2, -1, 4), 12))
    got = row_gather_backward_plain(torch.from_numpy(w), torch.from_numpy(idx), 12)
    assert np.array_equal(_bits(got), ref)
