"""Port: the whole serving slice against the JAX package, at a tiny size.

``hrnetv2_nodownsp_tiny``, 64x64 canvas, 16x16 task and saliency, radius 5,
51 classes, f32 on the CPU, the same PRNGKey(0) weights on both sides.
Tolerances: the grid to 1e-5 absolute and the logits to 1e-4 relative (see
test_torch_port_core.py and test_torch_port_models.py for why). Labels agree
on >= 99.5% of pixels: ``landing_scatter_max`` truncates grid coordinates,
so a 1e-7 difference in the grid can move a landing pixel, and the JAX
package on the CPU runs the lax jump-flood chain at full rounds while the
port runs the grid-derived rounds with the Pallas kernel's tie-breaks. Fed
the JAX ``pred`` and ``grid``, the port's labels are bit-equal to the
Pallas composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core.grid import landing_scatter_max as jax_landing_scatter_max
from fovealseg_tpu.core.unwarp import halfpixel_avg as jax_halfpixel_avg
from fovealseg_tpu.core.unwarp import jfa_rounds_from_grid as jax_jfa_rounds
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.ops.pallas_jfa import nearest_class_pallas
from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter
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


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    jm = JaxDeform(config=JaxConfig(**TINY))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(f))
    jax_out = jm.apply(v, jnp.asarray(x), jnp.asarray(f), argmax_labels=True,
                       method=JaxDeform.infer)
    jax_fwd = jm.apply(v, jnp.asarray(x), jnp.asarray(f), train=False)
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    out = model.infer(torch.from_numpy(x), torch.from_numpy(f), argmax_labels=True)
    fwd = model(torch.from_numpy(x), torch.from_numpy(f))
    return (jax.tree.map(np.asarray, jax_out), {k: t.numpy() for k, t in out.items()},
            jax.tree.map(np.asarray, jax_fwd), {k: t.numpy() for k, t in fwd.items()})


def test_infer_keys_and_layouts(both):
    jax_out, out, _, _ = both
    assert set(out) == set(jax_out)
    for k in out:
        assert out[k].shape == jax_out[k].shape, k
    assert out["pred_label"].dtype == np.int32


@pytest.mark.parametrize("key", ["xs", "grid", "grid_y"])
def test_infer_geometry(both, key):
    jax_out, out, _, _ = both
    np.testing.assert_allclose(out[key], jax_out[key], rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", ["x_sampled", "pred"])
def test_infer_warped_image_and_logits(both, key):
    """1e-4 relative: the sampled image moves with the grid's last bits
    (a 1e-6 grid difference is 3e-5 px on the 64-px canvas, times the
    frame's pixel-to-pixel contrast of up to 1), and the logits follow it."""
    jax_out, out, _, _ = both
    err = np.max(np.abs(out[key] - jax_out[key])) / np.max(np.abs(jax_out[key]))
    assert err <= 1e-4


def test_infer_inverse_grid(both):
    jax_out, out, _, _ = both
    np.testing.assert_array_equal(out["unfilled_mask"], jax_out["unfilled_mask"])
    np.testing.assert_array_equal(out["grid_inv"], jax_out["grid_inv"])  # NaN holes included


def test_infer_labels_agree(both):
    jax_out, out, _, _ = both
    assert (out["pred_label"] == jax_out["pred_label"]).mean() >= 0.995
    assert out["pred_label"].min() >= 0 and out["pred_label"].max() < 51


def test_labels_bit_equal_given_jax_pred_and_grid(both):
    jax_out, _, _, _ = both
    pred, grid = np.array(jax_out["pred"]), np.array(jax_out["grid"])
    seg_hw = (64, 64)
    got = unwarp_argmax_scatter(torch.from_numpy(pred), torch.from_numpy(grid), seg_hw,
                                rounds=jfa_rounds_from_grid(torch.from_numpy(grid), seg_hw))
    cls2 = jnp.argmax(jax_halfpixel_avg(jnp.asarray(pred)), axis=-1).astype(jnp.int32)
    combined = jnp.arange(256, dtype=jnp.int32)[None] * 64 + cls2.reshape(2, 256)
    canvas = jax_landing_scatter_max(jnp.asarray(grid), seg_hw, combined)
    valid = canvas >= 0
    ref = nearest_class_pallas(valid, jnp.where(valid, canvas % 64, 0), cls_bits=6,
                               interpret=True, rounds=jax_jfa_rounds(jnp.asarray(grid), seg_hw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("key", ["xs", "xs_our", "grid", "grid_y", "x_sampled", "pred"])
def test_warped_forward(both, key):
    _, _, jax_fwd, fwd = both
    assert set(fwd) == set(jax_fwd)
    err = np.max(np.abs(fwd[key] - jax_fwd[key])) / max(np.max(np.abs(jax_fwd[key])), 1.0)
    assert err <= 1e-4


def test_default_device_is_the_card():
    """Entry points default to CUDA; with no card they raise instead of
    carrying on quietly on the host."""
    if torch.cuda.is_available():
        assert DeformSegmentation(DeformConfig(**TINY)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeformSegmentation(DeformConfig(**TINY))


@pytest.mark.parametrize("branch", ["scoremap", "tri", "y_reverse", "x_reverse", "uniform",
                                    "gt_gradient", "f_xlr", "train"])
def test_later_slices_raise(branch):
    cfg = dict(TINY)
    cfg.update({"tri": {"rev_deform_interp": "tri"}, "uniform": {"uniform_sample": "BI"},
                "gt_gradient": {"gt_gradient": True}, "f_xlr": {"f_xlr_low_scale": 2}}.get(branch, {}))
    model = DeformSegmentation(DeformConfig(**cfg), device="cpu")
    x, f = torch.zeros((1, 64, 64, 3)), torch.full((1, 2), 0.5)
    kwargs = {"scoremap": dict(argmax_labels=False),
              "y_reverse": dict(argmax_labels=True, y_sampled_reverse=True, y=x[..., 0]),
              "x_reverse": dict(argmax_labels=True, x_sampled_reverse=True)}.get(
                  branch, dict(argmax_labels=True))
    with pytest.raises(NotImplementedError):
        if branch == "train":
            model(x, f, train=True)
        else:
            model.infer(x, f, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jfa_iters_fixes_the_round_count(dtype):
    """TPU.jfa_iters > 0 replaces the grid-derived count; at the full count
    the labels equal the full chain's."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    f = torch.full((1, 2), 0.4)
    torch.manual_seed(0)
    derived = DeformSegmentation(DeformConfig(**TINY), dtype=dtype, device="cpu")
    fixed = DeformSegmentation(DeformConfig(**TINY, jfa_iters=6), dtype=dtype, device="cpu")
    fixed.load_state_dict(derived.state_dict())
    out = fixed.infer(x, f, argmax_labels=True)
    full = unwarp_argmax_scatter(out["pred"].float(), out["grid"], (64, 64))
    torch.testing.assert_close(out["pred_label"], full, rtol=0, atol=0)
    assert torch.isfinite(derived.infer(x, f, argmax_labels=True)["pred"]).all()
