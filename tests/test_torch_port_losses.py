"""Port: the losses, ``resize_area``, ``compute_losses`` and the row
gather's gradient against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides as the same arrays.
Tolerances: each loss within 1e-6 relative and its gradient with respect to
the logits within 1e-6 of the gradient's largest element (f32 reductions in
another order); ``resize_area`` within 1e-6 (the same dense matrices, summed
in another order); ``compute_losses`` on the JAX forward's own outputs within
1e-5 relative and its gradients within 1e-5 of their largest element; the
plain scatter-add of K5b bit-equal to ``jax.grad`` through the flat gather
(both sum each row in ascending pixel order; ``tests/test_torch_port_k5b.py``
holds more cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import losses as JL
from fovealseg_tpu.core.interpolate import resize_area as jax_resize_area
from fovealseg_tpu.core.unwarp import _gather_rows_flat as jax_gather_rows_flat
from fovealseg_tpu.data.synthetic import make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
from fovealseg_tpu.train.step import compute_losses as jax_compute_losses
from fovealseg_torch.core import losses as L
from fovealseg_torch.core.interpolate import resize_area
from fovealseg_torch.ops.gather import row_gather, row_gather_backward, row_gather_backward_plain
from fovealseg_torch.train.step import LossConfig, compute_losses

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale if ref.size else 0.0
    assert got.shape == ref.shape and err <= rel, f"{what}: {err:.3g} > {rel}"


def _logits_labels(seed, c=7, shape=(2, 6, 5)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (*shape, c)).astype(np.float32)
    labels = rng.integers(0, c - 2, shape).astype(np.int32)  # two classes absent
    return logits, labels


LOGIT_LOSSES = {
    "dice_loss_multiclass": (JL.dice_loss_multiclass, L.dice_loss_multiclass, {}),
    "focal_loss": (JL.focal_loss, L.focal_loss, {}),
    "focal_loss_gamma2": (JL.focal_loss, L.focal_loss, {"gamma": 2.0}),
    "cross_entropy": (JL.cross_entropy, L.cross_entropy, {}),
    "ohem_cross_entropy": (JL.ohem_cross_entropy, L.ohem_cross_entropy, {"min_kept": 20}),
    "dice_loss_scores": (JL.dice_loss_scores, L.dice_loss_scores, {}),
    "wce_loss": (JL.wce_loss, L.wce_loss, {}),
}


@pytest.mark.parametrize("name", list(LOGIT_LOSSES))
def test_logit_loss_and_gradient(name):
    jfn, tfn, kw = LOGIT_LOSSES[name]
    logits, labels = _logits_labels(len(name))
    if name == "cross_entropy":
        labels[0, 0, :2] = -2  # the ignore label and a negative one
        labels[1, 1, 0] = -1
    if name == "wce_loss":
        logits, labels = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
    if name == "dice_loss_scores":  # scores, not logits: the criterion takes probabilities
        logits = np.random.default_rng(8).uniform(size=logits.shape).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = tfn(x, torch.from_numpy(labels), **kw)
    tl.backward()
    _close(tl.detach(), jl, 1e-6, name)
    _close(x.grad, jg, 1e-6, f"{name} gradient")


def test_cross_entropy_weighted():
    logits, labels = _logits_labels(3)
    w = np.linspace(0.5, 2.0, logits.shape[-1]).astype(np.float32)
    ref = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), weight=jnp.asarray(w))
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          weight=torch.from_numpy(w))
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("scale", [100.0, "tensor"])
def test_edge_loss_and_gradient(normalize, scale):
    rng = np.random.default_rng(4)
    sal = rng.uniform(0, 1, (2, 9, 9, 1)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 9, 9, 1)).astype(np.float32)
    jscale = jnp.float32(37.5) if scale == "tensor" else scale
    tscale = torch.tensor(37.5) if scale == "tensor" else scale
    jl, jg = jax.value_and_grad(
        lambda s: JL.edge_loss(s, jnp.asarray(tgt), jscale, normalize))(jnp.asarray(sal))
    s = torch.from_numpy(sal).requires_grad_(True)
    tl = L.edge_loss(s, torch.from_numpy(tgt), tscale, normalize)
    tl.backward()
    _close(tl.detach(), jl, 1e-6)
    _close(s.grad, jg, 1e-6, "gradient")
    _close(L.minmax_normalize(torch.from_numpy(sal)), JL.minmax_normalize(jnp.asarray(sal)), 1e-6)


@pytest.mark.parametrize("name", ["soft_dice_v1", "tv_loss", "bmse_loss", "dice_coeff"])
def test_map_losses(name):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 6, 1)).astype(np.float32)
    y = (rng.uniform(size=(2, 8, 6, 1)) > 0.6).astype(np.float32)
    if name in ("bmse_loss", "dice_coeff"):  # these take probabilities, not logits
        x = rng.uniform(size=x.shape).astype(np.float32)
    if name == "tv_loss":
        args_j, args_t = (jnp.asarray(x),), (torch.from_numpy(x),)
    else:
        args_j, args_t = (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))
    jl, jg = jax.value_and_grad(getattr(JL, name))(*args_j)
    xt = args_t[0].requires_grad_(True)
    tl = getattr(L, name)(xt, *args_t[1:])
    tl.backward()
    _close(tl.detach(), jl, 1e-6, name)
    _close(xt.grad, jg, 1e-6, f"{name} gradient")


def test_bcosim_loss():
    rng = np.random.default_rng(6)
    scores = rng.uniform(size=(40, 5)).astype(np.float32)
    target = rng.integers(0, 4, (40,)).astype(np.int32)
    ref = JL.bcosim_loss(jnp.asarray(scores), jnp.asarray(target), 5)
    got = L.bcosim_loss(torch.from_numpy(scores), torch.from_numpy(target), 5)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("src,dst", [((64, 64), (16, 16)), ((64, 64), (80, 80)),
                                     ((640, 640), (80, 80)), ((30, 50), (7, 9)), ((5, 5), (5, 5))])
def test_resize_area(src, dst):
    x = np.random.default_rng(sum(src)).uniform(size=(2, *src, 3)).astype(np.float32)
    _close(resize_area(torch.from_numpy(x), dst), jax_resize_area(jnp.asarray(x), dst), 1e-6)


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX module's eval forward (and its loss_at_high_res variant) on one
    synthetic b2 batch at the tiny size: the outputs compute_losses reads."""
    batch = make_batch(np.random.default_rng(31), 2, canvas=64)
    jm = JaxDeform(config=JaxConfig(**TINY))
    x, f = jnp.asarray(batch["img_data"]), jnp.asarray(batch["focus_point"])
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x, f)
    out = jax.tree.map(np.asarray, jax.jit(lambda v: jm.apply(v, x, f))(v))
    rng = np.random.default_rng(32)
    out["pred_hr"] = rng.normal(size=(2, 64, 64, 51)).astype(np.float32)
    return batch, out


LOSS_CONFIGS = {
    "default": ({}, {}),
    "joint": ({"deform_joint_loss": True}, {}),
    "edge_pil": ({"edge_norm": False, "deform_joint_loss": True, "edge_zero_bound": 2}, {}),
    "edge_pil_softmax": ({"edge_norm": False, "edge_target_softmax": True}, {}),
    "entropy": ({"entropy_reg_weight": 0.3}, {}),
    "uniform_bi": ({"uniform_bi": True}, {}),
    "edge_scale": ({"deform_joint_loss": True}, {"edge_scale": 12.5}),
    "edge_only": ({"deform_joint_loss": True}, {"edge_only": True}),
    "pred_hr": ({}, {"pred_hr": True}),
}


@pytest.mark.parametrize("name", list(LOSS_CONFIGS))
def test_compute_losses_on_jax_outputs(jax_outputs, name):
    """compute_losses given the JAX forward's own outputs: the loss, every
    metric and the gradients with respect to the logits and the saliency."""
    batch, out = jax_outputs
    over, extra = LOSS_CONFIGS[name]
    kw = dict(saliency_hw=(16, 16), **over)
    out = dict(out)
    if not extra.get("pred_hr"):
        out.pop("pred_hr")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "edge_scale" in extra:
        jb["edge_scale"], tb["edge_scale"] = jnp.float32(extra["edge_scale"]), extra["edge_scale"]
    if "edge_only" in extra:
        jb["edge_only"], tb["edge_only"] = jnp.bool_(True), True
    keys = ["pred", "xs_our", "xs"] + (["pred_hr"] if "pred_hr" in out else [])

    def jloss(diff):
        o = {**{k: jnp.asarray(v) for k, v in out.items()}, **diff}
        return jax_compute_losses(o, jb, JaxLossConfig(**kw))

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)({k: jnp.asarray(out[k]) for k in keys})
    to = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    for k in keys:
        to[k].requires_grad_(True)
    tl, tm = compute_losses(to, tb, LossConfig(**kw))
    tl.backward()
    _close(tl.detach(), jl, 1e-5, "loss")
    assert set(tm) == set(jm)
    for k in tm:
        _close(tm[k], jm[k], 1e-5, k)
    for k in keys:
        g = to[k].grad if to[k].grad is not None else torch.zeros_like(to[k])
        _close(g, jg[k], 1e-5, f"d loss / d {k}")


@pytest.mark.parametrize("b,t,c,n", [(2, 16, 51, 300), (3, 50, 1, 1000), (1, 7, 3, 40)])
def test_k5b_plain_equals_jax_grad_through_the_flat_gather(b, t, c, n):
    """``row_gather_backward_plain`` (and ``row_gather``'s autograd on the
    CPU) against ``jax.grad`` through ``core/unwarp.py::_gather_rows_flat``,
    bit for bit."""
    rng = np.random.default_rng(b * t + n)
    values = rng.normal(size=(b, t, c)).astype(np.float32)
    idx = rng.integers(0, t, (b, n)).astype(np.int32)
    w = rng.normal(size=(b, n, c)).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jax_gather_rows_flat(v, jnp.asarray(idx)) * w))(
        jnp.asarray(values))
    ref = np.asarray(ref).view(np.int32)
    got = row_gather_backward_plain(torch.from_numpy(w), torch.from_numpy(idx), t)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref)
    got = row_gather_backward(torch.from_numpy(w), torch.from_numpy(idx), t)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref)
    v = torch.from_numpy(values).requires_grad_(True)
    (row_gather(v, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy().view(np.int32), ref)


def test_k5b_clamps_like_the_forward():
    """Indices outside [0, T) are clamped in the backward as in the forward."""
    g = torch.ones((1, 4, 2))
    idx = torch.tensor([[-5, 0, 2, 9]], dtype=torch.int32)
    got = row_gather_backward_plain(g, idx, 3)
    torch.testing.assert_close(got, torch.tensor([[[2.0, 2.0], [0.0, 0.0], [2.0, 2.0]]]))
