"""Port: the class-mode jump flood's plain version against the Pallas kernel.

``nearest_class_plain`` (the CPU path of ``fovealseg_torch.ops.jfa``) must be
bit-equal to ``nearest_class_pallas`` run in interpret mode, as the JAX
package's own kernel tests run it: integer outputs, no tolerance. The CUDA
kernel's tiled trips, emulated with numpy, must be bit-equal to the plain
flood (the second half of this file).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core.grid import GridSolver as JaxGridSolver
from fovealseg_tpu.core.grid import landing_scatter_max as jax_landing_scatter_max
from fovealseg_tpu.core.grid import pad_saliency as jax_pad_saliency
from fovealseg_tpu.core.unwarp import nearest_seed_payload
from fovealseg_tpu.ops.pallas_jfa import nearest_class_pallas
from fovealseg_torch.ops.jfa import (_flood_plain, full_rounds, nearest_class, nearest_class_plain,
                                    tile_shape)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sparse(seed, shape, p_hole):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(0, 1, shape) > p_hole
    valid[:, 3, 5] = True
    cls = rng.integers(0, 51, shape).astype(np.int32)
    return valid, cls


def _landing(seed):
    """Seeds as the serving path makes them: a Gaussian-solved grid from a
    random saliency map, scattered to a 64x64 canvas."""
    rng = np.random.default_rng(seed)
    sal = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32) ** 4
    sal = sal / sal.sum(axis=(1, 2, 3), keepdims=True)
    solver = JaxGridSolver(16, 16, 5, 5, 5.0)
    grid, _ = solver.create_grid(jax_pad_saliency(jnp.asarray(sal), 5, 5), (16, 16))
    keys = rng.integers(0, 2**20, (2, 256)).astype(np.int32)
    canvas = np.asarray(jax_landing_scatter_max(grid, (64, 64), jnp.asarray(keys)))
    valid = canvas >= 0
    return valid, np.where(valid, canvas % 64, 0).astype(np.int32)


def _pallas(valid, cls, rounds):
    r = None if rounds is None else jnp.int32(rounds)
    return np.asarray(nearest_class_pallas(jnp.asarray(valid), jnp.asarray(cls), cls_bits=6,
                                           interpret=True, rounds=r))


def _plain(valid, cls, rounds):
    r = None if rounds is None else torch.tensor(rounds, dtype=torch.int32)
    return nearest_class_plain(torch.from_numpy(valid), torch.from_numpy(cls), 6, rounds=r).numpy()


CASES = {
    "sparse32": lambda: _sparse(0, (2, 32, 32), 0.92),
    "sparse48x80": lambda: _sparse(1, (2, 48, 80), 0.97),
    "sparse64_far": lambda: _sparse(2, (1, 64, 64), 0.995),
    "landing64": lambda: _landing(3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("rounds", ["1", "2", "4", "full", "full+2"])
def test_plain_bit_equal_to_pallas(case, rounds):
    valid, cls = CASES[case]()
    full = full_rounds(*valid.shape[1:])
    r = {"full": full, "full+2": full + 2}.get(rounds) or int(rounds)
    np.testing.assert_array_equal(_plain(valid, cls, r), _pallas(valid, cls, r))


@pytest.mark.parametrize("case", sorted(CASES))
def test_default_rounds_is_full_chain(case):
    """rounds=None runs the full chain in both."""
    valid, cls = CASES[case]()
    np.testing.assert_array_equal(_plain(valid, cls, None), _pallas(valid, cls, None))


@pytest.mark.parametrize("case", ["sparse32", "sparse48x80", "sparse64_far"])
def test_full_chain_against_lax_chain(case):
    """The lax chain (``core/unwarp.py::nearest_seed_payload``, the JAX
    package's CPU path) clamps shifted reads at the border where the Pallas
    kernel treats them as out of range, so equidistant seeds can tie-break
    differently: the plain version's seed is never farther than the lax
    chain's, and at least 95% of payloads agree (the bound the JAX package's
    own Pallas-vs-lax test uses)."""
    valid, _ = CASES[case]()
    b, h, w = valid.shape
    flat = np.broadcast_to(np.arange(h * w, dtype=np.int32).reshape(1, h, w), valid.shape)
    ours = nearest_class_plain(torch.from_numpy(valid), torch.from_numpy(flat.copy()), 30).numpy()
    lax = np.asarray(nearest_seed_payload(jnp.asarray(valid), jnp.asarray(np.where(valid, flat, 0))))
    ys, xs = np.mgrid[0:h, 0:w]

    def d2(f):
        return (f // w - ys) ** 2 + (f % w - xs) ** 2

    for i in range(b):
        assert (d2(ours[i]) <= d2(lax[i])).all()
    assert (ours == lax).mean() >= 0.95


def test_rounds_as_int_tensor_or_clipped():
    valid, cls = CASES["sparse32"]()
    v, c = torch.from_numpy(valid), torch.from_numpy(cls)
    full = full_rounds(32, 32)
    as_int = nearest_class_plain(v, c, 6, rounds=3)
    as_tensor = nearest_class_plain(v, c, 6, rounds=torch.tensor(3, dtype=torch.int32))
    torch.testing.assert_close(as_int, as_tensor, rtol=0, atol=0)
    # out-of-range counts clip to [1, full], as the Pallas kernel clips them
    torch.testing.assert_close(nearest_class_plain(v, c, 6, rounds=0),
                               nearest_class_plain(v, c, 6, rounds=1), rtol=0, atol=0)
    torch.testing.assert_close(nearest_class_plain(v, c, 6, rounds=full + 9),
                               nearest_class_plain(v, c, 6, rounds=None), rtol=0, atol=0)


def test_no_seed_gives_zero():
    valid = torch.zeros((1, 16, 16), dtype=torch.bool)
    cls = torch.full((1, 16, 16), 7, dtype=torch.int32)
    assert (nearest_class_plain(valid, cls, 6) == 0).all()


def test_wrapper_takes_plain_version_on_cpu():
    valid, cls = CASES["landing64"]()
    v, c = torch.from_numpy(valid), torch.from_numpy(cls)
    before = nearest_class.launches
    torch.testing.assert_close(nearest_class(v, c, 6, rounds=4),
                               nearest_class_plain(v, c, 6, rounds=4), rtol=0, atol=0)
    assert nearest_class.launches == before  # no kernel launched for host tensors


@pytest.mark.parametrize("bad", ["valid_dtype", "payload_dtype", "shape", "rank", "cls_bits"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    v = torch.ones((1, 8, 8), dtype=torch.bool)
    c = torch.zeros((1, 8, 8), dtype=torch.int32)
    cls_bits = 6
    if bad == "valid_dtype":
        v = v.to(torch.int32)
    elif bad == "payload_dtype":
        c = c.to(torch.int64)
    elif bad == "shape":
        c = torch.zeros((1, 8, 9), dtype=torch.int32)
    elif bad == "rank":
        v, c = v[0], c[0]
    else:
        cls_bits = 0
    with pytest.raises(ValueError):
        nearest_class(v, c, cls_bits)


# --- the CUDA flood's tiles, emulated on the CPU ------------------------------
#
# csrc/jfa.cu runs one launch per trip: a tile is a block of Ry x Rx residue
# classes mod k and a TA x TB window of their stride-k sublattice, loaded with
# a 3-cell halo (1 where the window holds whole classes) into a flat shared
# array (t fastest, then b, a, u) and updated
# by the 8 directions in order, each a Jacobi step over the whole tile; cells
# off the canvas hold -1 and are never updated, and only the window's own
# cells are written back. The helpers below do exactly that with numpy, with
# the kernel's layout (a neighbour is the cell at a fixed flat offset, so a
# halo cell at the tile's edge reads another class or the -1 padding), and
# hold the result bit-equal to the plain flood.

_DIRS = [(sy, sx) for sy in (-1, 0, 1) for sx in (-1, 0, 1) if (sy, sx) != (0, 0)]


def _d2(seed, y, x):
    return ((seed >> 16) - y) ** 2 + ((seed & 0xFFFF) - x) ** 2


def _tiled_trip(state, k, shape, update_off_canvas=False):
    """One trip at step k over [B, H, W] seed positions ((y << 16) | x, or
    -1), tile by tile with tiles (Ry, Rx, TA, TB, halo)."""
    bsz, h, w = state.shape
    ry, rx, ta, tb, halo = shape
    assert k % ry == 0 and k % rx == 0, "a tile's classes must be distinct mod k"
    assert halo == 3 or (ta >= -(-h // k) and tb >= -(-w // k)), "halo 1 needs whole classes"
    tas, tbs = ta + 2 * halo, tb + 2 * halo
    u, a, b, t = (g.ravel() for g in np.meshgrid(np.arange(ry), np.arange(tas), np.arange(tbs),
                                                  np.arange(rx), indexing="ij"))
    n = u.size
    pad = tbs * rx + rx  # the kernel's padding: a neighbour's offset is at most this
    cells = pad + np.arange(n)
    window = (a >= halo) & (a < halo + ta) & (b >= halo) & (b < halo + tb)
    out = np.full_like(state, -1)
    written = np.zeros(state.shape, np.int64)
    for img in range(bsz):
        for ry0 in range(0, min(k, h), ry):
            for rx0 in range(0, min(k, w), rx):
                for a0 in range(0, -(-h // k), ta):
                    for b0 in range(0, -(-w // k), tb):
                        y = ry0 + u + k * (a0 - halo + a)
                        x = rx0 + t + k * (b0 - halo + b)
                        on = (y >= 0) & (y < h) & (x >= 0) & (x < w)
                        cur = np.where(on, state[img, y.clip(0, h - 1), x.clip(0, w - 1)], -1)
                        best = np.where(cur >= 0, _d2(cur, y, x), 2**31 - 1)
                        live = on | update_off_canvas
                        s = np.full(n + 2 * pad, -1, np.int64)
                        for sy, sx in _DIRS:
                            s[cells] = cur
                            cand = s[cells + (sy * tbs + sx) * rx]
                            d = _d2(cand, y, x)
                            win = live & (cand >= 0) & (d < best)
                            cur, best = np.where(win, cand, cur), np.where(win, d, best)
                        keep = window & on
                        out[img, y[keep], x[keep]] = cur[keep]
                        written[img, y[keep], x[keep]] += 1
    assert (written == 1).all(), "every pixel lies in exactly one tile's window"
    return out


def _flood_tiled(valid, rounds, shape_of=tile_shape, update_off_canvas=False):
    """The kernel's trips: seeds from ``valid``, then r + 1 tiled trips."""
    _, h, w = valid.shape
    r = min(max(rounds, 1), full_rounds(h, w))
    ys, xs = np.mgrid[0:h, 0:w]
    state = np.where(valid, (ys << 16) | xs, -1).astype(np.int64)
    for i in range(r + 1):
        k = max((1 << (r - 1)) >> i, 1)
        state = _tiled_trip(state, k, shape_of(k, h, w), update_off_canvas)
    return state


def _flood_plain_words(valid, rounds):
    sy, sx = _flood_plain(torch.from_numpy(valid), rounds)
    sy, sx = sy.numpy().astype(np.int64), sx.numpy().astype(np.int64)
    return np.where(sy >= 0, (sy << 16) | sx, -1)


def _random_canvas(seed):
    """A random mask of a random odd, non-square or one-pixel-wide shape, with
    an empty batch element, and a random round count in [1, full + 2]."""
    rng = np.random.default_rng(1000 + seed)
    h, w = [(1, 37), (29, 1), (5, 5), (70, 70), (33, 65), (1, 1)][seed] if seed < 6 else \
        rng.integers(5, 71, 2)
    valid = rng.uniform(0, 1, (3, h, w)) > rng.choice([0.7, 0.95, 0.995])
    valid[1] = False  # an image with no seed
    valid[2, rng.integers(h), rng.integers(w)] = True
    return valid, int(rng.integers(1, full_rounds(h, w) + 3))


@pytest.mark.parametrize("seed", range(30))
def test_tiled_trips_bit_equal_to_plain(seed):
    """The kernel's own tiles (``tile_shape``) on 30 random canvases from 1x1
    to 70x70 (the first six fixed: 1 pixel wide or tall, odd, non-square)."""
    valid, rounds = _random_canvas(seed)
    np.testing.assert_array_equal(_flood_tiled(valid, rounds), _flood_plain_words(valid, rounds))


@pytest.mark.parametrize("ry,rx,ta,tb", [(1, 1, 1, 1), (2, 1, 2, 3), (1, 2, 5, 2), (2, 4, 3, 7),
                                         (4, 2, 9, 4), (1, 8, 1, 13)])
@pytest.mark.parametrize("seed", [3, 4, 7, 11])
def test_tiled_trips_any_tile_shape(ry, rx, ta, tb, seed):
    """Windows from 1x1 up, with as many classes per tile as the step allows,
    and a halo of 1 wherever the window holds whole classes: every tile shape
    gives the plain flood's winners."""
    valid, rounds = _random_canvas(seed)
    valid = valid[:, :24, :36]
    rounds = min(rounds, full_rounds(*valid.shape[1:]) + 2)

    def shape_of(k, h, w):
        whole = ta >= -(-h // k) and tb >= -(-w // k)
        return min(ry, k), min(rx, k), ta, tb, 1 if whole else 3

    np.testing.assert_array_equal(_flood_tiled(valid, rounds, shape_of),
                                  _flood_plain_words(valid, rounds))


def test_off_canvas_cells_are_never_updated():
    """The trap of the tiled design. One seed at (0, 6), one step inside the
    right border of a 2 x 8 canvas; rounds 1 gives two trips of step 1, which
    reach (0, 0) but not (1, 0). A tile holds the canvas and a 3-cell ring
    around it. If the ring's off-canvas cells took part, row 2 (below the
    canvas) would relay the seed: in the first trip (1, 6) -> (2, 5) by
    direction (-1, 1), -> (2, 4) by (0, 1), -> (1, 3) by (1, 1), a pixel the
    flood reaches only in the second trip; in the second, (1, 3) -> (2, 2) ->
    (2, 1) -> (1, 0) the same way. Each step reads a candidate that the
    sequential semantics treat as off the canvas."""
    valid = np.zeros((1, 2, 8), bool)
    valid[0, 0, 6] = True
    seed = (0 << 16) | 6
    plain = _flood_plain_words(valid, 1)
    assert plain[0, 0, 0] == seed and plain[0, 1, 0] == -1
    np.testing.assert_array_equal(_flood_tiled(valid, 1), plain)
    np.testing.assert_array_equal(_flood_tiled(valid, 1, update_off_canvas=True)[0, 1],
                                  [seed] * 8)
    state = np.where(valid, seed, -1).astype(np.int64)
    shape = tile_shape(1, 2, 8)
    assert shape[4] == 3  # the canvas fits one tile, its border cells in the halo
    assert _tiled_trip(state, 1, shape)[0, 1, 3] == -1
    assert _tiled_trip(state, 1, shape, update_off_canvas=True)[0, 1, 3] == seed


def test_tile_table_mirrored_in_kernel_source():
    """``tile_shape`` is the emulation's tile choice; csrc/jfa.cu's tile table,
    block size and whole-class sizes must be the same, and the choice must
    fall where the kernel's note says at 640x640."""
    import re
    from pathlib import Path

    from fovealseg_torch.ops.jfa import REGISTER_CLASSES, THREADS, TILES

    src = (Path(__file__).resolve().parent.parent / "fovealseg_torch" / "csrc" / "jfa.cu").read_text()
    table = re.search(r"constexpr Tile tile\(int i\) \{(.*?)\n\}", src, re.S).group(1)
    assert tuple(tuple(map(int, t)) for t in re.findall(
        r"Tile\{(\d+), (\d+), (\d+), (\d+), (\d+)\}", table)) == TILES
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == THREADS
    whole = re.findall(r"if \(extent <= (\d)\) return flood_classes<(\d)>", src)
    assert [(int(e), int(f)) for e, f in whole] == [(e, e) for e in REGISTER_CLASSES]
    at640 = {k: tile_shape(k, 640, 640) for k in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)}
    assert at640 == {1: TILES[0], 2: TILES[1], 4: TILES[2], 8: TILES[3], 16: TILES[9],
                     32: TILES[8], 64: TILES[7], 128: TILES[6], 256: (1, 1, 3, 3, 1),
                     512: (1, 1, 2, 2, 1)}
