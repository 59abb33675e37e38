"""Port: the training forward's options against the JAX package, on the
CPU at the tiny size (``hrnetv2_nodownsp_tiny``, 64x64 canvas, 16x16 task),
dropout off on both sides (patched for the module, as in
``test_torch_port_train.py``).

``xs_override``, ``MODEL.gt_gradient`` (with and without the label-edge
sampler), the ``edge_only`` window and the pretrain pool (``pool_s``) each
run one train-mode loss and its gradients on both sides. Tolerances: the
loss within 1e-5 relative, 1e-3 with the label-edge sampler (the JAX
package's own jitted and eager losses differ by 4.2e-4 there: the sampler
puts task pixels on the instance's border, where the warped label's
truncation to ids follows a 2.4e-7 move of the grid; the port matches the
eager one to 2.4e-7); the saliency nets' gradient, where it reaches them
only through the pre-override saliency ``xs_our`` (``MODEL.gt_gradient``,
``edge_only``: no encoder on the way), within 1e-4 of its norm; every other
gradient within 5% (the train-mode sensitivity of the tiny encoder to the
warped image's last bits, ``test_torch_port_train.py``); gradients the JAX
package stops are zero on both sides.

``MODEL.loss_at_high_res``: the JAX package's own inverse warps
(``unwarp_prediction_fast``, ``unwarp_prediction`` 'BI') are run with their
flood replaced by the port's flood output (the JAX CPU flood tie-breaks
equidistant seeds its own way, ``test_torch_port_jfa.py``), and held to the
port's: values bit-equal for 'nearest' and within 1e-6 for 'BI' (the splat's
sums in another order), gradients with respect to the prediction within 1e-6
of their largest element. The port's model-level ``pred_hr`` is its inverse
warp of ``pred``, and its saliency nets receive a gradient through the row
gather's backward.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fovealseg_tpu.core.unwarp as jax_unwarp
from fovealseg_tpu.data.synthetic import make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
from fovealseg_tpu.train.step import compute_losses as jax_compute_losses
from fovealseg_torch.core.grid import grid_from_index, inverse_grid_index
from fovealseg_torch.core.unwarp import (
    jfa_rounds_from_grid,
    unwarp_prediction,
    unwarp_prediction_fast,
)
from fovealseg_torch.models import layers
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.ops import gather
from fovealseg_torch.ops.jfa import nearest_payload_packed, nearest_seed
from fovealseg_torch.train.checkpoint import from_jax_variables
from fovealseg_torch.train.step import LossConfig, compute_losses

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
SALIENCY = ("localization", "net_compress")


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(layers.Dropout, "forward", lambda self, x: x)
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def init():
    batch = make_batch(np.random.default_rng(51), 2, canvas=64)
    jm = JaxDeform(config=JaxConfig(**TINY))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batch["img_data"]),
                         jnp.asarray(batch["focus_point"]))
    return batch, jax.tree.map(np.asarray, v)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


OVERRIDE = np.random.default_rng(52).uniform(size=(2, 16, 16, 1)).astype(np.float32)
XS_OUR_ONLY = ("gt_gradient", "gt_gradient_sampler", "edge_only")
CASES = {  # model config, loss config, forward and batch extras
    "xs_override": ({}, {}, {"xs_override": True}),
    "gt_gradient": ({"gt_gradient": True}, {"deform_joint_loss": True}, {}),
    "gt_gradient_sampler": ({"gt_gradient": True, "fix_gt_gradient": True},
                            {"deform_joint_loss": True}, {}),
    "edge_only": ({}, {"deform_joint_loss": True}, {"edge_only": True}),
    "pool_s": ({}, {}, {"pool_s": 7}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_option_matches_jax(init, case):
    batch, v = init
    over, lover, extra = CASES[case]
    jm = JaxDeform(config=JaxConfig(**TINY, **over))
    lcfg = dict(saliency_hw=(16, 16), **lover)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    if extra.get("edge_only"):
        jb["edge_only"], tb["edge_only"] = jnp.bool_(True), True
    y = batch["seg_label"] if over.get("gt_gradient") else None
    kw_j = dict(y=None if y is None else jnp.asarray(y), pool_s=extra.get("pool_s"),
                xs_override=jnp.asarray(OVERRIDE) if extra.get("xs_override") else None)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jb["img_data"],
                          jb["focus_point"], train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                          mutable=["batch_stats"], **kw_j)
        total, _ = jax_compute_losses(out, jb, JaxLossConfig(**lcfg))
        return total, out

    (jl, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    ref = from_jax_variables(jax.tree.map(np.asarray, jg), {})

    model = DeformSegmentation(DeformConfig(**TINY, **over), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    out = model(tb["img_data"], tb["focus_point"], train=True,
                y=None if y is None else torch.from_numpy(y), pool_s=extra.get("pool_s"),
                xs_override=torch.from_numpy(OVERRIDE) if extra.get("xs_override") else None,
                rng=torch.Generator().manual_seed(0))
    tl, _ = compute_losses(out, tb, LossConfig(**lcfg))
    tl.backward()
    loss_tol = 1e-3 if case == "gt_gradient_sampler" else 1e-5
    assert abs(float(tl.detach()) - float(jl)) <= loss_tol * abs(float(jl))
    for k in ("xs", "xs_our", "grid"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    scale = float(np.max(np.abs(np.asarray(jout["x_sampled"]))))
    assert float(np.max(np.abs(out["x_sampled"].detach().numpy()
                               - np.asarray(jout["x_sampled"])))) <= 1e-4 * scale
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    for sub in ("localization", "net_compress", "encoder", "decoder"):
        ks = sorted(k for k in ref if k.startswith(sub + "."))
        g = np.concatenate([grads[k].ravel() for k in ks])
        r = np.concatenate([ref[k].ravel() for k in ks])
        if not np.any(r):  # a gradient the JAX package stops
            assert not np.any(g), (case, sub)
        else:
            tight = sub in SALIENCY and case in XS_OUR_ONLY
            assert _rel(g, r) <= (1e-4 if tight else 5e-2), (case, sub, _rel(g, r))
    if case == "xs_override":
        np.testing.assert_array_equal(out["xs"].detach().numpy(), OVERRIDE)
    if case in ("gt_gradient", "gt_gradient_sampler", "edge_only"):
        # the saliency nets train through xs_our alone, and they do train
        assert any(np.any(grads[k]) for k in grads if k.startswith("localization."))
    if case == "edge_only":
        assert not any(np.any(grads[k]) for k in grads if k.startswith(("encoder.", "decoder.")))


@pytest.fixture(scope="module")
def high_res_case(init):
    """The port's tiny train forward and the inverse-warp inputs it gives."""
    batch, v = init
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(batch["img_data"]), torch.from_numpy(batch["focus_point"]))
    grid = out["grid"]
    task_idx, valid = inverse_grid_index(grid, (64, 64))
    rounds = jfa_rounds_from_grid(grid, (64, 64))
    pred = np.random.default_rng(53).normal(size=(2, 16, 16, 51)).astype(np.float32)
    w = np.random.default_rng(54).normal(size=(2, 64, 64, 51)).astype(np.float32)
    return dict(grid=grid, task_idx=task_idx, valid=valid, rounds=rounds, pred=pred, w=w)


def test_high_res_nearest_matches_jax(high_res_case, monkeypatch):
    c = high_res_case
    tidx = nearest_payload_packed(c["valid"], c["task_idx"], 8, c["rounds"])
    monkeypatch.setattr(jax_unwarp, "_nearest_payload",
                        lambda *a, **k: jnp.asarray(tidx.numpy()))
    ti, va = jnp.asarray(c["task_idx"].numpy()), jnp.asarray(c["valid"].numpy())

    def f(p):
        return jax_unwarp.unwarp_prediction_fast(p, ti, va)

    ref, vjp = jax.vjp(f, jnp.asarray(c["pred"]))
    (ref_g,) = vjp(jnp.asarray(c["w"]))
    p = torch.from_numpy(c["pred"]).requires_grad_(True)
    got = unwarp_prediction_fast(p, c["task_idx"], c["valid"], None, c["rounds"])
    (got * torch.from_numpy(c["w"])).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    g, r = p.grad.numpy(), np.asarray(ref_g)
    assert np.max(np.abs(g - r)) <= 1e-6 * np.max(np.abs(r))


def test_high_res_bi_matches_jax(high_res_case, monkeypatch):
    c = high_res_case
    seeds = nearest_seed(c["valid"])
    monkeypatch.setattr(jax_unwarp, "_nearest_seed", lambda *a, **k: jnp.asarray(seeds.numpy()))
    grid_inv = grid_from_index(c["task_idx"], c["valid"], (16, 16))
    gi, va = jnp.asarray(grid_inv.numpy()), jnp.asarray(c["valid"].numpy())
    ref, vjp = jax.vjp(lambda p: jax_unwarp.unwarp_prediction(p, gi, va, interp="BI"),
                       jnp.asarray(c["pred"]))
    (ref_g,) = vjp(jnp.asarray(c["w"]))
    p = torch.from_numpy(c["pred"]).requires_grad_(True)
    got = unwarp_prediction(p, grid_inv, c["valid"], interp="BI")
    (got * torch.from_numpy(c["w"])).sum().backward()
    r = np.asarray(ref)
    assert np.max(np.abs(got.detach().numpy() - r)) <= 1e-6 * np.max(np.abs(r))
    g, rg = p.grad.numpy(), np.asarray(ref_g)
    assert np.max(np.abs(g - rg)) <= 1e-6 * np.max(np.abs(rg))


@pytest.mark.parametrize("interp", ["nearest", "BI"])
def test_high_res_forward_trains_the_saliency_through_the_row_gather(init, interp):
    """The model's ``pred_hr`` is the port's inverse warp of its ``pred`` at
    its grid, the seg loss on it reaches the saliency nets (the joint edge
    loss is off, so only through the row gather's backward), and the
    backward goes through ``RowGather``."""
    batch, v = init
    model = DeformSegmentation(DeformConfig(**TINY, loss_at_high_res=True, rev_deform_interp=interp),
                               device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    out = model(tb["img_data"], tb["focus_point"], train=True, rng=torch.Generator())
    assert out["pred_hr"].shape == (2, 64, 64, 51)
    with torch.no_grad():
        ref = model._pred_high_res(out["pred"], out["grid"], (64, 64))
    torch.testing.assert_close(out["pred_hr"].detach(), ref, rtol=0, atol=0)
    seen = []
    real = gather.row_gather_backward

    def spy(*a):
        seen.append(a[0].shape)
        return real(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather, "row_gather_backward", spy)
        loss, _ = compute_losses(out, tb, LossConfig(saliency_hw=(16, 16)))
        loss.backward()
    assert seen, "the row gather's backward did not run"
    sal = torch.cat([p.grad.reshape(-1) for n, p in model.named_parameters()
                     if n.startswith(SALIENCY) and p.grad is not None])
    assert float(sal.norm()) > 0


def test_low_scale_saliency_only_at_inference(init):
    """``VAL.F_Xlr_low_scale`` shrinks the saliency input at inference only,
    as the JAX module gates it on ``not train``: the training forward's
    saliency equals the default config's bit for bit, the eval forward's
    does not."""
    batch, v = init
    x, f = torch.from_numpy(batch["img_data"]), torch.from_numpy(batch["focus_point"])
    outs = {}
    for scale in (0, 2):
        model = DeformSegmentation(DeformConfig(**TINY, f_xlr_low_scale=scale), device="cpu")
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
        outs[scale] = (model(x, f, train=True, rng=torch.Generator())["xs_our"].detach(),
                       model(x, f)["xs_our"])
    torch.testing.assert_close(outs[2][0], outs[0][0], rtol=0, atol=0)
    assert not torch.equal(outs[2][1], outs[0][1])
