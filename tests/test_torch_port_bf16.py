"""Port: bfloat16 compute against the JAX package (the default
``TPU.compute_dtype``), on the CPU.

The port rounds bf16 where the JAX package rounds it:

* the forward warp casts the image to bf16 first and blends with bf16 tap
  weights, rounding after every operation (``core/warp.py``);
* a bilinear resize of a bf16 tensor contracts with a bf16 matrix and
  rounds after each axis (``core/interpolate.py``).

Both are held bit-equal to the JAX package on the same inputs. The slice
as a whole is not bit-equal: the convolutions round their bf16 sums in
another order in each framework, and the saliency and grid follow. So the
tiny slice holds, against the JAX package with the same weights:

* ``xs`` within 1e-2 of its largest value (measured: 3e-3), the grid within
  5e-4 (measured: 7e-5);
* the logits within 2e-2 of their largest magnitude (measured: 0.75%, two
  bf16 ulps at the logits' scale);
* the served labels on >= 99% of pixels (measured: all of them);
* ``x_sampled`` bit-equal to the port's warp of the image at the JAX
  package's own grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import grid as jgrid
from fovealseg_tpu.core import interpolate as jinterp
from fovealseg_tpu.core import warp as jwarp
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_torch.core import interpolate, warp
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import from_jax_variables

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))


def _solver_grid(seed, task=(16, 16), sal=(16, 16), radius=5):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, (2, *sal, 1)).astype(np.float32) ** 4
    s = s / s.sum(axis=(1, 2, 3), keepdims=True)
    solver = jgrid.GridSolver(sal[0], sal[1], radius, radius * (sal[1] // sal[0]), float(radius))
    xs = jgrid.pad_saliency(jnp.asarray(s), solver.pad_x, solver.pad_y)
    return np.asarray(solver.create_grid(xs, task)[0])


@pytest.mark.parametrize("grid_kind", ["solver", "random", "border"])
def test_warp_bit_equal_to_jax(grid_kind):
    """The bf16 warp, op by op as the JAX package's packed sampler rounds:
    a solver grid, random coordinates past the canvas on every side, and a
    grid on the canvas border and the pixel centres' ties."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    if grid_kind == "solver":
        grid = _solver_grid(3)
    elif grid_kind == "random":
        grid = rng.uniform(-1.2, 1.2, (2, 16, 16, 2)).astype(np.float32)
    else:
        ticks = np.linspace(-1.0, 1.0, 17, dtype=np.float32)
        grid = np.stack(np.meshgrid(ticks, ticks), axis=-1)[None].repeat(2, axis=0)
    ref = jwarp.grid_sample(jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(grid))
    got = warp.grid_sample(torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jax_bits(ref))


@pytest.mark.parametrize("in_hw,out_hw", [((10, 10), (80, 80)), ((20, 20), (80, 80)),
                                          ((640, 640), (80, 80)), ((16, 24), (64, 40))])
def test_resize_bilinear_bf16_bit_equal_to_jax(in_hw, out_hw):
    x = np.random.default_rng(sum(in_hw)).normal(0, 1, (2, *in_hw, 5)).astype(np.float32)
    ref = jinterp.resize_bilinear(jnp.asarray(x).astype(jnp.bfloat16), out_hw)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = interpolate.resize_bilinear(xt, out_hw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jax_bits(ref))
    nchw = interpolate.resize_bilinear_nchw(xt.permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(_bits(nchw.permute(0, 2, 3, 1)), _jax_bits(ref))


def test_resize_bilinear_f32_keeps_one_rounding():
    """float32 inputs keep the single-rounding path (1e-5 of the JAX
    package's, as test_torch_port_core.py holds)."""
    x = np.random.default_rng(1).normal(0, 1, (2, 20, 20, 3)).astype(np.float32)
    ref = np.asarray(jinterp.resize_bilinear(jnp.asarray(x), (80, 80)))
    got = interpolate.resize_bilinear(torch.from_numpy(x), (80, 80))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    jm = JaxDeform(config=JaxConfig(**TINY), dtype=jnp.bfloat16)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(f))
    jax_out = jm.apply(v, jnp.asarray(x), jnp.asarray(f), argmax_labels=True,
                       method=JaxDeform.infer)
    jax_fwd = jm.apply(v, jnp.asarray(x), jnp.asarray(f), train=False)
    model = DeformSegmentation(DeformConfig(**TINY), dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    out = model.infer(torch.from_numpy(x), torch.from_numpy(f), argmax_labels=True)
    fwd = model(torch.from_numpy(x), torch.from_numpy(f))
    return x, jax_out, out, jax_fwd, fwd


@pytest.mark.parametrize("call", ["infer", "forward"])
def test_bf16_slice_within_tolerance(both, call):
    _, jax_out, out, jax_fwd, fwd = both
    ref, got = (jax_out, out) if call == "infer" else (jax_fwd, fwd)
    ref = _f32(ref)
    got = {k: t.float().numpy() for k, t in got.items()}
    assert got["x_sampled"].shape == ref["x_sampled"].shape
    assert (out if call == "infer" else fwd)["x_sampled"].dtype == torch.bfloat16
    xs_err = np.abs(got["xs"] - ref["xs"]).max() / np.abs(ref["xs"]).max()
    assert xs_err <= 1e-2
    np.testing.assert_allclose(got["grid"], ref["grid"], rtol=0, atol=5e-4)
    pred_err = np.abs(got["pred"] - ref["pred"]).max() / np.abs(ref["pred"]).max()
    assert pred_err <= 2e-2


def test_bf16_x_sampled_bit_equal_at_the_jax_grid(both):
    x, jax_out, out, _, _ = both
    got = warp.grid_sample(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(np.asarray(jax_out["grid"])))
    np.testing.assert_array_equal(_bits(got), _jax_bits(jax_out["x_sampled"]))
    # and the port's own x_sampled is that warp at the port's own grid
    own = warp.grid_sample(torch.from_numpy(x).to(torch.bfloat16), out["grid"])
    np.testing.assert_array_equal(_bits(own), _bits(out["x_sampled"]))


def test_bf16_labels_agree(both):
    _, jax_out, out, _, _ = both
    labels = out["pred_label"].numpy()
    assert labels.dtype == np.int32 and labels.shape == jax_out["pred_label"].shape
    assert (labels == np.asarray(jax_out["pred_label"])).mean() >= 0.99
