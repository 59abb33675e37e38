"""Port: the score-map and label inverse warps against the JAX package.

The plain versions of K2-K5 (``fovealseg_torch/ops/{jfa,gather}.py``, the CPU
path of each wrapper) must be bit-equal to the Pallas kernels run in
interpret mode, as the JAX package's own kernel tests run them: integer and
gathered f32 outputs, no tolerance. Each ``core/unwarp.py`` function is held
against its JAX namesake:

* integer outputs and f32 gathers exactly;
* the 5x5 splat fill to 1e-5 relative (25 shifted f32 accumulations in the
  same order; XLA and PyTorch may contract or round the products
  differently in the last bit);
* the bilinear sample at the filled coordinates to 1e-5 absolute (as
  ``test_torch_port_core.py::test_grid_sample_bilinear``).

On the CPU the JAX package runs its jump floods as the lax chain, which
clamps shifted reads at the border where the Pallas kernel treats them as out
of range, so equidistant seeds tie-break differently
(``test_torch_port_jfa.py``). Against the lax chain the tests therefore hold
seed distances (the port's seed is never farther), compare values on the
pixels whose seed agrees, and hold the composition with the Pallas kernels
bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import grid as jgrid
from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.core import warp as jwarp
from fovealseg_tpu.ops.pallas_gather import windowed_row_gather
from fovealseg_tpu.ops.pallas_jfa import (
    nearest_payload_packed_pallas,
    nearest_payload_pallas,
    nearest_seed_pallas,
)
from fovealseg_torch.core import grid, unwarp, warp
from fovealseg_torch.ops import jfa
from fovealseg_torch.ops.gather import row_gather, row_gather_plain


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


def _sparse(seed, shape, p_hole):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(0, 1, shape) > p_hole
    valid[:, 3, 5] = True
    pay = rng.integers(0, 2**13, shape).astype(np.int32)
    return valid, pay


def _grid(seed, task=(16, 16)):
    rng = np.random.default_rng(seed)
    sal = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32) ** 4
    sal = sal / sal.sum(axis=(1, 2, 3), keepdims=True)
    solver = jgrid.GridSolver(16, 16, 5, 5, 5.0)
    g, _ = solver.create_grid(jgrid.pad_saliency(jnp.asarray(sal), 5, 5), task)
    return _np(g)


def _landing(seed):
    """Seeds as the score-map path makes them: the flat task index of a
    Gaussian-solved 16x16 grid, scattered to a 64x64 canvas."""
    canvas, valid = jgrid.inverse_grid_index(jnp.asarray(_grid(seed)), (64, 64))
    return _np(valid), _np(canvas)


CASES = {
    "sparse32": lambda: _sparse(0, (2, 32, 32), 0.92),
    "sparse48x80": lambda: _sparse(1, (2, 48, 80), 0.97),
    "sparse64_far": lambda: _sparse(2, (1, 64, 64), 0.995),
    "landing64": lambda: _landing(3),
}
ROUNDS = [None, 3, 7, 9]  # 9 > REL_MAX_ROUNDS: K2's fallback to 'payload' mode


def _r(rounds):
    return None if rounds is None else jnp.int32(rounds)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", ROUNDS, ids=str)
def test_payload_packed_plain_bit_equal_to_pallas(case, rounds):
    """K2: ``nearest_payload_packed_plain`` == 'relpay' (or its lax.cond
    fallback) in interpret mode."""
    valid, pay = CASES[case]()
    ref = nearest_payload_packed_pallas(jnp.asarray(valid), jnp.asarray(pay), 13,
                                        interpret=True, rounds=_r(rounds))
    got = jfa.nearest_payload_packed_plain(_t(valid), _t(pay), 13, rounds)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", ROUNDS, ids=str)
def test_payload_plain_bit_equal_to_pallas(case, rounds):
    """K3: ``nearest_payload_plain`` == 'payload' mode in interpret mode,
    here with payloads wider than K2 takes."""
    valid, pay = CASES[case]()
    pay = pay * 7919 + 2**20
    ref = nearest_payload_pallas(jnp.asarray(valid), jnp.asarray(pay), interpret=True,
                                 rounds=_r(rounds))
    got = jfa.nearest_payload_plain(_t(valid), _t(pay), rounds)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", ROUNDS, ids=str)
def test_seed_plain_bit_equal_to_pallas(case, rounds):
    """K4: ``nearest_seed_plain`` == 'seed' mode in interpret mode."""
    valid, _ = CASES[case]()
    ref = nearest_seed_pallas(jnp.asarray(valid), rounds, interpret=True)
    got = jfa.nearest_seed_plain(_t(valid), rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("case", ["sparse32", "sparse48x80", "landing64"])
def test_seed_against_lax_chain(case):
    """The JAX package's CPU seed chain (``nearest_seed_jfa``) tie-breaks
    differently at the border: the port's seed is never farther, and at
    least 95% of seeds agree (the bound of the JAX package's own
    Pallas-vs-lax test)."""
    valid, _ = CASES[case]()
    b, h, w = valid.shape
    ours = jfa.nearest_seed_plain(_t(valid)).numpy()
    lax = _np(junwarp._nearest_seed(jnp.asarray(valid)))
    ys, xs = np.mgrid[0:h, 0:w]

    def d2(f):
        return (f // w - ys) ** 2 + (f % w - xs) ** 2

    for i in range(b):
        assert (d2(ours[i]) <= d2(lax[i])).all()
    assert (ours == lax).mean() >= 0.95


def test_no_seed_gives_zero():
    valid = torch.zeros((1, 16, 16), dtype=torch.bool)
    pay = torch.full((1, 16, 16), 7, dtype=torch.int32)
    assert (jfa.nearest_payload_packed_plain(valid, pay, 13) == 0).all()
    assert (jfa.nearest_payload_plain(valid, pay) == 0).all()
    assert (jfa.nearest_seed_plain(valid) == 0).all()


def test_wrappers_take_plain_versions_on_cpu():
    valid, pay = CASES["landing64"]()
    v, p = _t(valid), _t(pay)
    counts = [f.launches for f in (jfa.nearest_payload_packed, jfa.nearest_payload,
                                   jfa.nearest_seed, row_gather)]
    torch.testing.assert_close(jfa.nearest_payload_packed(v, p, 13, 4),
                               jfa.nearest_payload_packed_plain(v, p, 13, 4), rtol=0, atol=0)
    torch.testing.assert_close(jfa.nearest_payload(v, p, 4), jfa.nearest_payload_plain(v, p, 4),
                               rtol=0, atol=0)
    torch.testing.assert_close(jfa.nearest_seed(v, 4), jfa.nearest_seed_plain(v, 4),
                               rtol=0, atol=0)
    table = torch.arange(2 * 256 * 3, dtype=torch.float32).reshape(2, 256, 3)
    idx = p.clamp(max=255)
    torch.testing.assert_close(row_gather(table, idx), row_gather_plain(table, idx),
                               rtol=0, atol=0)
    assert counts == [f.launches for f in (jfa.nearest_payload_packed, jfa.nearest_payload,
                                           jfa.nearest_seed, row_gather)]


@pytest.mark.parametrize("bad", ["valid_dtype", "payload_dtype", "shape", "pay_bits"])
def test_jfa_wrappers_reject_what_the_kernels_do_not_take(bad):
    v = torch.ones((1, 8, 8), dtype=torch.bool)
    p = torch.zeros((1, 8, 8), dtype=torch.int32)
    pay_bits = 13
    if bad == "valid_dtype":
        v = v.to(torch.uint8)
    elif bad == "payload_dtype":
        p = p.to(torch.int64)
    elif bad == "shape":
        p = torch.zeros((1, 8, 9), dtype=torch.int32)
    else:
        pay_bits = 0
    with pytest.raises(ValueError):
        jfa.nearest_payload_packed(v, p, pay_bits)
    if bad != "pay_bits":
        with pytest.raises(ValueError):
            jfa.nearest_payload(v, p)
    if bad == "valid_dtype":
        with pytest.raises(ValueError):
            jfa.nearest_seed(v)


def _warp_idx(rng, b, h, w, t):
    """Monotone foveated warp index field, as ``tests/test_pallas_gather.py``
    makes it (the jump flood output's locality)."""
    side = int(np.sqrt(t))
    idxs = []
    for _ in range(b):
        g = rng.uniform(0.2, 0.8, 2)
        wy = 1.0 / (np.abs(np.linspace(0, 1, h) - g[0]) + 0.08)
        wx = 1.0 / (np.abs(np.linspace(0, 1, w) - g[1]) + 0.08)
        ty = np.clip((np.cumsum(wy) / wy.sum() * (side - 1e-3)).astype(np.int64), 0, side - 1)
        tx = np.clip((np.cumsum(wx) / wx.sum() * (side - 1e-3)).astype(np.int64), 0, side - 1)
        idxs.append(ty[:, None] * side + tx[None, :])
    return np.stack(idxs).astype(np.int32)


@pytest.mark.parametrize("kind", ["warp", "random"])
def test_row_gather_plain_bit_equal_to_windowed_pallas(kind):
    """K5: ``row_gather_plain`` == ``windowed_row_gather(interpret=True)``
    at b2, T=1024, 128x128, C=51, on a warp index (the windowed path) and on
    random indices (its fallback to the flat gather)."""
    rng = np.random.default_rng(0 if kind == "warp" else 1)
    vals = rng.standard_normal((2, 1024, 51)).astype(np.float32)
    if kind == "warp":
        idx = _warp_idx(rng, 2, 128, 128, 1024)
    else:
        idx = rng.integers(0, 1024, (2, 128, 128)).astype(np.int32)
    ref = windowed_row_gather(jnp.asarray(vals), jnp.asarray(idx), interpret=True)
    got = row_gather_plain(_t(vals), _t(idx))
    assert got.shape == (2, 128, 128, 51)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_row_gather_int32_and_rejects():
    table = torch.arange(2 * 10 * 2, dtype=torch.int32).reshape(2, 10, 2)
    idx = torch.tensor([[3, 0, 9], [1, 1, 2]], dtype=torch.int32)
    got = row_gather_plain(table, idx)
    assert got.dtype == torch.int32
    assert got.tolist() == [[[6, 7], [0, 1], [18, 19]], [[22, 23], [22, 23], [24, 25]]]
    with pytest.raises(ValueError):
        row_gather(table.to(torch.int64), idx)
    with pytest.raises(ValueError):
        row_gather(table, idx.to(torch.int64))
    with pytest.raises(ValueError):
        row_gather(table, idx[:1])


def test_gather_rows_flat():
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 300)).astype(np.int32)
    ref = junwarp._gather_rows_flat(jnp.asarray(vals), jnp.asarray(idx))
    np.testing.assert_array_equal(unwarp._gather_rows_flat(_t(vals), _t(idx)).numpy(), _np(ref))


@pytest.mark.parametrize("dy,dx", [(0, 0), (-2, 1), (2, -2), (5, 3)])
def test_shift2d_clamps_at_the_edge(dy, dx):
    x = np.random.default_rng(5).standard_normal((2, 6, 7, 3)).astype(np.float32)
    ref = junwarp._shift2d(jnp.asarray(x), dy, dx)
    np.testing.assert_array_equal(unwarp._shift2d(_t(x), dy, dx).numpy(), _np(ref))


def test_nearest_payload_dispatch(monkeypatch):
    """cls_bits -> K1; pay_bits <= 13 -> K2; wider -> K3; K2 with a host
    count above 7 -> K3 (the TPU kernel's lax.cond)."""
    calls = []
    for name in ("nearest_class", "nearest_payload_packed", "nearest_payload"):
        real = getattr(jfa, name)
        monkeypatch.setattr(unwarp, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    real_k3 = jfa.nearest_payload
    monkeypatch.setattr(jfa, "nearest_payload",
                        lambda *a: calls.append("nearest_payload via K2") or real_k3(*a))
    valid, pay = CASES["sparse32"]()
    v, p = _t(valid), _t(pay)
    unwarp._nearest_payload(v, p % 64, cls_bits=6)
    unwarp._nearest_payload(v, p, rounds=torch.tensor(3, dtype=torch.int32), pay_bits=13)
    unwarp._nearest_payload(v, p, pay_bits=20)
    unwarp._nearest_payload(v, p, num_iters=9, pay_bits=13)
    unwarp._nearest_payload(v, p, num_iters=4, pay_bits=13)
    assert calls == ["nearest_class", "nearest_payload_packed", "nearest_payload",
                     "nearest_payload_packed", "nearest_payload via K2", "nearest_payload_packed"]


@pytest.fixture(scope="module")
def scene():
    """A landing geometry (16x16 task grid -> 64x64 canvas) with task-space
    scores, labels and the seeds of both floods."""
    rng = np.random.default_rng(6)
    g = _grid(6)
    pred = rng.standard_normal((2, 16, 16, 51)).astype(np.float32)
    labels = rng.integers(0, 51, (2, 16, 16, 1)).astype(np.float32)
    task_idx, valid = jgrid.inverse_grid_index(jnp.asarray(g), (64, 64))
    rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(g), (64, 64))
    tidx_pallas = nearest_payload_packed_pallas(valid, task_idx, 8, interpret=True, rounds=rounds)
    seed_pallas = nearest_seed_pallas(valid, interpret=True)
    return dict(g=g, pred=pred, labels=labels, task_idx=_np(task_idx), valid=_np(valid),
                rounds=int(rounds), tidx_pallas=_np(tidx_pallas), seed_pallas=_np(seed_pallas),
                tidx_lax=_np(junwarp.nearest_seed_payload(valid, task_idx)),
                seed_lax=_np(junwarp.nearest_seed_jfa(valid)))


def test_inverse_grid(scene):
    ref, valid_ref = jgrid.inverse_grid(jnp.asarray(scene["g"]), (64, 64))
    got, valid = grid.inverse_grid(_t(scene["g"]), (64, 64))
    np.testing.assert_array_equal(valid.numpy(), _np(valid_ref))
    np.testing.assert_array_equal(got.numpy(), _np(ref))  # NaN holes included


def test_grid_sample_nearest():
    """Exact, ties included: the grid's -1 border (ix = -0.5, zero padding
    under round-half-away) and half-integer interior coordinates."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    g = rng.uniform(-1.1, 1.1, (2, 9, 13, 2)).astype(np.float32)
    g[:, 0, :, 0] = -1.0  # ix = -0.5
    g[:, 1, :, 1] = 1.0  # iy = 11.5, rounds to 12: off the image
    g[:, 2, :, 0] = (2 * np.arange(13) + 2.0) / 16 - 1.0  # ix = k + 0.5 exactly
    ref = _np(jwarp.grid_sample(jnp.asarray(img), jnp.asarray(g), mode="nearest"))
    got = warp.grid_sample(_t(img), _t(g), mode="nearest").numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 0] == 0).all() and (got[:, 1] == 0).all()  # zero padding at the ties


def _fast_args(scene, rounds=True):
    r = torch.tensor(scene["rounds"], dtype=torch.int32) if rounds else None
    return _t(scene["task_idx"]), _t(scene["valid"]), None, r


def test_unwarp_prediction_fast(scene):
    """Bit-equal to the Pallas composition (K2 in interpret mode, then the
    flat gather of the half-pixel average); against the JAX function on the
    CPU (lax chain, full rounds), equal on every pixel whose task index
    agrees."""
    pred = scene["pred"]
    got = unwarp.unwarp_prediction_fast(_t(pred), *_fast_args(scene)).numpy()
    p2 = junwarp.halfpixel_avg(jnp.asarray(pred)).reshape(2, 256, 51)
    ref = _np(junwarp._gather_rows_flat(p2, jnp.asarray(scene["tidx_pallas"]).reshape(2, -1)))
    np.testing.assert_array_equal(got, ref.reshape(got.shape))
    lax = _np(junwarp.unwarp_prediction_fast(jnp.asarray(pred), jnp.asarray(scene["task_idx"]),
                                             jnp.asarray(scene["valid"])))
    same = scene["tidx_pallas"] == scene["tidx_lax"]
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(got[same], lax[same])


def test_unwarp_prediction_fast_options(scene):
    """``gather_impl='windowed'`` serves the same map; ``gather_bf16``
    (``TPU.scoremap_gather_bf16``) rounds the rows to bf16 before the gather,
    bit-equal to the Pallas composition with the JAX package's rounding, and
    'windowed' ignores it, as the JAX package's Pallas path does."""
    pred = _t(scene["pred"])
    args = _fast_args(scene)
    exact = unwarp.unwarp_prediction_fast(pred, *args)
    torch.testing.assert_close(unwarp.unwarp_prediction_fast(pred, *args, gather_impl="windowed"),
                               exact, rtol=0, atol=0)
    p2 = junwarp.halfpixel_avg(jnp.asarray(scene["pred"])).reshape(2, 256, 51)
    ref = _np(junwarp._gather_rows_flat(p2.astype(jnp.bfloat16),
                                        jnp.asarray(scene["tidx_pallas"]).reshape(2, -1)))
    got = unwarp.unwarp_prediction_fast(pred, *args, gather_bf16=True)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32).reshape(got.shape))
    torch.testing.assert_close(unwarp.unwarp_prediction_fast(pred, *args, gather_bf16=True,
                                                             gather_impl="windowed"),
                               exact, rtol=0, atol=0)


def test_unwarp_argmax_fast(scene):
    """The argmax of the fast score map, taken in task space: bit-equal to
    the Pallas composition and to the argmax of ``unwarp_prediction_fast``."""
    pred = scene["pred"]
    got = unwarp.unwarp_argmax_fast(_t(pred), *_fast_args(scene))
    assert got.dtype == torch.int32
    cls2 = _np(jnp.argmax(junwarp.halfpixel_avg(jnp.asarray(pred)), axis=-1)).reshape(2, 256)
    ref = np.take_along_axis(cls2, scene["tidx_pallas"].reshape(2, -1), axis=1)
    np.testing.assert_array_equal(got.numpy().reshape(2, -1), ref)
    dense = unwarp.unwarp_prediction_fast(_t(pred), *_fast_args(scene))
    torch.testing.assert_close(got, torch.argmax(dense, dim=-1).to(torch.int32), rtol=0, atol=0)


@pytest.mark.parametrize("rounds", ["runtime", "full"])
def test_unwarp_labels_fast(scene, rounds):
    labels = scene["labels"]
    got = unwarp.unwarp_labels_fast(_t(labels), *_fast_args(scene, rounds == "runtime")).numpy()
    tidx = scene["tidx_pallas"]
    if rounds == "full":
        tidx = _np(nearest_payload_packed_pallas(jnp.asarray(scene["valid"]),
                                                 jnp.asarray(scene["task_idx"]), 8,
                                                 interpret=True))
    ref = np.take_along_axis(labels.reshape(2, 256), tidx.reshape(2, -1), axis=1)
    np.testing.assert_array_equal(got.reshape(2, -1), ref)
    lax = _np(junwarp.unwarp_labels_fast(jnp.asarray(labels), jnp.asarray(scene["task_idx"]),
                                         jnp.asarray(scene["valid"])))
    same = tidx == scene["tidx_lax"]
    np.testing.assert_array_equal(got[same], lax[same])


def test_fill_grid_and_values_nearest(scene):
    grid_inv, valid = jgrid.inverse_grid(jnp.asarray(scene["g"]), (64, 64))
    safe = _np(jnp.where(jnp.isnan(grid_inv), 0.0, grid_inv))
    seeds = scene["seed_pallas"].reshape(2, -1, 1)
    got = unwarp.fill_grid_nearest(_t(safe), _t(valid)).numpy()
    np.testing.assert_array_equal(got.reshape(2, -1, 2),
                                  np.take_along_axis(safe.reshape(2, -1, 2), seeds, axis=1))
    vals = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    got_v = unwarp.fill_values_nearest(_t(vals), _t(valid)).numpy()
    np.testing.assert_array_equal(got_v.reshape(2, -1, 3),
                                  np.take_along_axis(vals.reshape(2, -1, 3), seeds, axis=1))
    same = scene["seed_pallas"] == scene["seed_lax"]
    lax = _np(junwarp.fill_values_nearest(jnp.asarray(vals), valid))
    np.testing.assert_array_equal(got_v[same], lax[same])


def _reached(valid):
    """Pixels the 5x5 splat reaches: a valid pixel in the edge-clamped window."""
    vf = _t(valid[..., None].astype(np.float32))
    acc = sum(unwarp._shift2d(vf, dy, dx) for dy in range(-2, 3) for dx in range(-2, 3))
    return acc.numpy()[..., 0] > 0


def test_fill_values_splat(scene):
    """1e-5 relative against the JAX function on every pixel the splat
    reaches or whose nearest seed agrees with the lax chain's; bit-equal to
    the K4 Pallas composition at the pixels the splat does not reach."""
    valid = scene["valid"]
    vals = np.random.default_rng(9).standard_normal((2, 64, 64, 5)).astype(np.float32)
    vals = vals * valid[..., None]
    got = unwarp.fill_values_splat(_t(vals), _t(valid)).numpy()
    ref = _np(junwarp.fill_values_splat(jnp.asarray(vals), jnp.asarray(valid)))
    reached = _reached(valid)
    ok = reached | (scene["seed_pallas"] == scene["seed_lax"])
    assert ok.mean() >= 0.95 and (~reached).any()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-5 * np.abs(ref).max())
    far = np.take_along_axis(vals.reshape(2, -1, 5), scene["seed_pallas"].reshape(2, -1, 1), axis=1)
    np.testing.assert_array_equal(got[~reached], far.reshape(got.shape)[~reached])


@pytest.mark.parametrize("interp", ["nearest", "BI", "tri"])
def test_unwarp_prediction(scene, interp):
    """Against the JAX function to 1e-5 absolute (the bilinear sample and,
    for 'BI'/'tri', the splat) on the pixels whose nearest seed agrees with
    the lax chain's or, for 'BI'/'tri', that the splat reaches."""
    grid_inv, valid = jgrid.inverse_grid(jnp.asarray(scene["g"]), (64, 64))
    pred = scene["pred"][..., :7]
    got = unwarp.unwarp_prediction(_t(pred), _t(grid_inv), _t(valid), interp=interp).numpy()
    ref = _np(junwarp.unwarp_prediction(jnp.asarray(pred), grid_inv, valid, interp=interp))
    ok = scene["seed_pallas"] == scene["seed_lax"]
    if interp != "nearest":
        ok = ok | _reached(scene["valid"])
    assert ok.mean() >= 0.95
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        unwarp.unwarp_prediction(_t(pred), _t(grid_inv), _t(valid), interp="bicubic")
