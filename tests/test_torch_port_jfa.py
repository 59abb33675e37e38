"""Port: the class-mode jump flood's plain version against the Pallas kernel.

``nearest_class_plain`` (the CPU path of ``fovealseg_torch.ops.jfa``) must be
bit-equal to ``nearest_class_pallas`` run in interpret mode, as the JAX
package's own kernel tests run it: integer outputs, no tolerance.
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
from fovealseg_torch.ops.jfa import full_rounds, nearest_class, nearest_class_plain


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
