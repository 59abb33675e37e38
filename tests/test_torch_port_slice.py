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
def weights():
    """The frames, block labels and the JAX PRNGKey(0) weights."""
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    y = rng.integers(0, 51, (2, 4, 4)).astype(np.int32).repeat(16, 1).repeat(16, 2)
    jm = JaxDeform(config=JaxConfig(**TINY))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(f))
    return x, f, y, v


@pytest.fixture(scope="module")
def both(weights):
    x, f, _, v = weights
    jm = JaxDeform(config=JaxConfig(**TINY))
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


# The branches that raised before the eval slice, with the model config and
# the ``infer`` arguments that reach them. The first seven run now; the last
# three are still to port.
BRANCHES = {
    "scoremap": ({"uniform_sample": "nearest"}, dict(argmax_labels=False)),
    "tri": ({"rev_deform_interp": "tri", "uniform_sample": "BI"}, dict(argmax_labels=False)),
    "y_reverse": ({"uniform_sample": "BI"}, dict(argmax_labels=True, y_sampled_reverse=True)),
    "x_reverse": ({"uniform_sample": "BI"}, dict(argmax_labels=True, x_sampled_reverse=True)),
    "uniform": ({"uniform_sample": "BI"}, dict(argmax_labels=True)),
    "gt_gradient": ({"gt_gradient": True}, dict(argmax_labels=True)),
    "f_xlr": ({"f_xlr_low_scale": 2}, dict(argmax_labels=True)),
}
STILL_TO_PORT = ["train", "xs_override", "loss_at_high_res"]  # ported with training
_JAX_RUNS: dict = {}


def _jax_infer(weights, over, kw):
    """The JAX package's infer for one config, with every output the
    branches compare (both round trips on for the uniform-'BI' config)."""
    x, f, y, v = weights
    if over == {"uniform_sample": "BI"}:
        kw = dict(argmax_labels=True, y_sampled_reverse=True, x_sampled_reverse=True)
    key = (tuple(sorted(over.items())), tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jm = JaxDeform(config=JaxConfig(**TINY, **over))
        out = jm.apply(v, jnp.asarray(x), jnp.asarray(f), y=jnp.asarray(y),
                       method=JaxDeform.infer, **kw)
        _JAX_RUNS[key] = jax.tree.map(np.asarray, out)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("branch", [*BRANCHES, *STILL_TO_PORT])
def test_later_slices_raise(weights, branch):
    """Each branch that raised before the eval slice or the training slice.
    The uniform baselines (their score map, 'tri' variant, round trips and
    labels), ``MODEL.gt_gradient`` with labels and ``VAL.F_Xlr_low_scale``
    run and are held against the JAX package with the slice's tolerances:
    the geometry to 1e-5, the logits and the maps made from them to 1e-4
    relative, labels on >= 99.5% of pixels, the uniform-'BI' label round trip
    exactly. The three branches of the training slice run too
    (:func:`_training_branch`)."""
    x, f, y, v = weights
    if branch in STILL_TO_PORT:
        _training_branch(weights, branch)
        return
    over, kw = BRANCHES[branch]
    ref = _jax_infer(weights, over, kw)
    model = DeformSegmentation(DeformConfig(**TINY, **over), device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    got = {k: t.numpy() for k, t in model.infer(torch.from_numpy(x), torch.from_numpy(f),
                                                y=torch.from_numpy(y), **kw).items()}
    assert set(got) <= set(ref) and ("pred_label" in got) == kw["argmax_labels"]
    for k in ("xs", "grid", "grid_y"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("x_sampled", "pred", "pred_sampled", "x_sampled_reverse"):
        if k in got:
            err = np.max(np.abs(got[k] - ref[k])) / max(np.max(np.abs(ref[k])), 1.0)
            assert got[k].shape == ref[k].shape and err <= 1e-4, k
    if "pred_label" in got:
        assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.995
    for k in ("y_sampled", "y_sampled_reverse"):
        if k in got:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (branch in ("y_reverse",)) == ("y_sampled_reverse" in got)
    assert (branch in ("x_reverse",)) == ("x_sampled_reverse" in got)


def test_gt_gradient_without_labels_passes_through(both):
    """``MODEL.gt_gradient`` with ``y=None``: the JAX module applies the
    label-edge override only when labels are given, so it serves the default
    path. The port does the same: its output equals its default output bit
    for bit, and the JAX package's gt_gradient output within the slice's
    tolerances (the grid to 1e-5, labels on >= 99.5% of pixels)."""
    jax_default, default, _, _ = both
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    jm = JaxDeform(config=JaxConfig(**TINY, gt_gradient=True))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(f))
    jax_out = jax.tree.map(np.asarray, jm.apply(v, jnp.asarray(x), jnp.asarray(f),
                                                argmax_labels=True, method=JaxDeform.infer))
    model = DeformSegmentation(DeformConfig(**TINY, gt_gradient=True), device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    out = {k: t.numpy() for k, t in model.infer(torch.from_numpy(x), torch.from_numpy(f),
                                                argmax_labels=True).items()}
    assert set(out) == set(default)
    for k in out:
        np.testing.assert_array_equal(out[k], default[k], err_msg=k)
        np.testing.assert_array_equal(jax_out[k], jax_default[k], err_msg=k)
    np.testing.assert_allclose(out["grid"], jax_out["grid"], rtol=0, atol=1e-5)
    assert (out["pred_label"] == jax_out["pred_label"]).mean() >= 0.995


def test_scoremap_gather_bf16_raises():
    """TPU.scoremap_gather_bf16 stands in ROADMAP's "Not to port" list."""
    model = DeformSegmentation(DeformConfig(**TINY, scoremap_gather_bf16=True), device="cpu")
    with pytest.raises(NotImplementedError, match="Not to port"):
        model.infer(torch.zeros((1, 64, 64, 3)), torch.full((1, 2), 0.5))


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


def _training_branch(weights, branch):
    """The training slice's branches against the JAX package:

    * 'train': the train-mode forward with dropout off on both sides (the
      streams cannot match): the geometry to 1e-5, the warped image to 1e-4
      relative, the logits to 5e-4 (train-mode BN over the coarsest branch's 8
      values per channel amplifies the image's last bits: 1.2e-4 measured);
    * 'xs_override': the eval forward with a fixed saliency, every output
      within the slice's tolerances and ``xs`` the override exactly;
    * 'loss_at_high_res': fed the JAX forward's ``pred`` and ``grid``, the
      port's full-res prediction is bit-equal to the JAX package's gather at
      the Pallas flood's indices (interpret mode); the model's own
      ``pred_hr`` agrees with it within 1e-4 relative on >= 99.5% of pixels
      (a landing pixel moves when a grid coordinate straddles an integer)."""
    import flax.linen as nn

    from fovealseg_tpu.core.grid import inverse_grid_index as jax_inverse_grid_index
    from fovealseg_tpu.core.unwarp import _gather_rows_flat
    from fovealseg_tpu.ops.pallas_jfa import nearest_payload_packed_pallas
    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import unwarp_prediction_fast
    from fovealseg_torch.models import layers

    x, f, _, v = weights
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    over = {"loss_at_high_res": True} if branch == "loss_at_high_res" else {}
    model = DeformSegmentation(DeformConfig(**TINY, **over), device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    jm = JaxDeform(config=JaxConfig(**TINY))
    if branch == "train":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(nn.Dropout, "__call__", lambda self, a, *r, **k: a)
            mp.setattr(layers.Dropout, "forward", lambda self, a: a)
            ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(f), train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
            got = model(xt, ft, train=True, rng=torch.Generator().manual_seed(0))
        tol = {"x_sampled": 1e-4, "pred": 5e-4}
    elif branch == "xs_override":
        ov = np.random.default_rng(23).uniform(size=(2, 16, 16, 1)).astype(np.float32)
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(f), xs_override=jnp.asarray(ov))
        got = model(xt, ft, xs_override=torch.from_numpy(ov))
        np.testing.assert_array_equal(got["xs"].numpy(), ov)
        tol = {"x_sampled": 1e-4, "pred": 1e-4}
    else:
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(f))
        got = model(xt, ft)
        tol = {"x_sampled": 1e-4, "pred": 1e-4}
    ref = jax.tree.map(np.asarray, ref)
    got = {k: t.detach().numpy() for k, t in got.items()}
    assert set(got) - {"pred_hr"} == set(ref)
    for k in ("xs", "xs_our", "grid", "grid_y"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
    for k, t in tol.items():
        assert np.max(np.abs(got[k] - ref[k])) <= t * np.max(np.abs(ref[k])), k
    if branch != "loss_at_high_res":
        return
    pred, grid = ref["pred"], ref["grid"]
    task_idx, valid = jax_inverse_grid_index(jnp.asarray(grid), (64, 64))
    tidx = nearest_payload_packed_pallas(valid, task_idx, 8, interpret=True,
                                         rounds=jax_jfa_rounds(jnp.asarray(grid), (64, 64)))
    p2 = jax_halfpixel_avg(jnp.asarray(pred)).reshape(2, 256, 51)
    want = np.asarray(_gather_rows_flat(p2, tidx.reshape(2, -1))).reshape(2, 64, 64, 51)
    ti, va = inverse_grid_index(torch.from_numpy(grid), (64, 64))
    fed = unwarp_prediction_fast(torch.from_numpy(pred), ti, va, None,
                                 jfa_rounds_from_grid(torch.from_numpy(grid), (64, 64)))
    np.testing.assert_array_equal(fed.numpy(), want)
    close = np.abs(got["pred_hr"] - want).max(axis=-1) <= 1e-4 * np.abs(want).max()
    assert got["pred_hr"].shape == (2, 64, 64, 51) and close.mean() >= 0.995
