"""Port: the training forward, the train step and the optimizer against the
JAX package, on the CPU at the tiny size (``hrnetv2_nodownsp_tiny``, 64x64
canvas, 16x16 task), weights carried over with ``from_jax_variables``.

Dropout streams cannot match across frameworks, so the parity tests run with
dropout off on both sides, set here: ``flax.linen.Dropout.__call__`` and the
port's ``Dropout.forward`` are patched to the identity for the module.
``test_dropout_is_live_and_reproducible`` shows the port's dropout separately.

Tolerances, and why:

* the training forward: the geometry to 1e-5 and the warped image to 1e-4
  relative (the slice's tolerances), the logits to 5e-4 relative (train-mode
  BN over the coarsest branch's 8 values per channel amplifies the warped
  image's last bits: 1.2e-4 measured), and every BN running statistic within
  2e-4 relative (the batch statistics summed in another order);
* the encoder and decoder backward, given the same warped image and upstream
  gradient: the decoder's gradient within 1e-4 of its norm, the encoder's
  within 1e-2 (on this input the port's own f32 encoder gradient is 6.6e-4
  from its float64 one, and the JAX package's f32 sums, its BN variance
  taken as E[x^2] - E[x]^2, land 4.1e-3 away);
* a whole train step is far more sensitive. Measured on the host alone:
  moving the warped image by 1.4e-5 of its scale (what the grid's last bits
  do) moves the tiny encoder's train-mode gradients by 2.3% in norm, because
  its coarsest BN branch normalises 8 values. So one default step holds the
  loss to 1e-5, each group's SGD update to 5% of its norm, every element of
  an Adam update to 2.01 learning rates (Adam's first step moves an element
  by ~lr whatever its gradient's size, so a gradient at the noise level
  moves +lr on one side and -lr on the other; the norm of such an update
  says nothing), and the BN statistics' update to 1e-3 of its norm;
* three consecutive steps run where the warped image is bit-equal on both
  sides (``MODEL.uniform_sample='BI'``: a plain 64->16 resize whose matrix
  has two taps per row), with the joint edge loss on so that all four groups
  train, at ``lr_mult`` 1e-5: the loss per step to 1e-4, the saliency group's
  update to 5e-3 of its norm, the others' to 0.1, the BN statistics' to 1e-3.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
from fovealseg_tpu.data.synthetic import make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train.optim import create_optimizer as jax_create_optimizer
from fovealseg_tpu.train.optim import edge_loss_scale_at as jax_edge_loss_scale_at
from fovealseg_tpu.train.optim import make_stage_schedules as jax_schedules
from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
from fovealseg_tpu.train.step import TrainState as JaxTrainState
from fovealseg_tpu.train.step import make_train_step as jax_make_train_step
from fovealseg_torch.configs import get_default_cfg
from fovealseg_torch.data.loader import prefetch
from fovealseg_torch.data.synthetic import make_batch_device
from fovealseg_torch.models import layers
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train import step as S
from fovealseg_torch.train.checkpoint import from_jax_variables
from fovealseg_torch.train.optim import (
    GROUPS,
    create_optimizer,
    edge_loss_scale_at,
    make_stage_schedules,
    poly_running_lrs,
    set_learning_rates,
)

TINY_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
             "TRAIN.epoch_iters", "10"]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """2 torch threads; dropout off on both sides for the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(layers.Dropout, "forward", lambda self, x: x)
        yield
    torch.set_num_threads(prev)


def cfgs(*opts):
    """(JAX cfg, port cfg): deform.yaml with the tiny options and ``opts``."""
    out = []
    for make in (jax_default_cfg, get_default_cfg):
        c = make()
        c.merge_from_file("fovealseg_torch/configs/deform.yaml")
        c.merge_from_list(TINY_OPTS + list(opts))
        c.TRAIN.max_iters = c.TRAIN.epoch_iters * c.TRAIN.num_epoch
        out.append(c)
    return out


@pytest.fixture(scope="module")
def init():
    """One synthetic b2 batch and the JAX PRNGKey(0) variables."""
    batch = make_batch(np.random.default_rng(41), 2, canvas=64)
    jc, _ = cfgs()
    jm = JaxDeform(config=JaxConfig.from_cfg(jc))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batch["img_data"]),
                         jnp.asarray(batch["focus_point"]))
    return batch, jax.tree.map(np.asarray, v)


def port_model(v, pc):
    model = DeformSegmentation(DeformConfig.from_cfg(pc), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    return model


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _close(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-30)
    assert got.shape == ref.shape and err <= rel, f"{what}: {err:.3g} > {rel}"


def _by_group(sd: dict, stats: bool) -> dict:
    """{group: concatenated values} of a state dict's parameters (or BN
    running statistics)."""
    out = {}
    for name, sub, _, _ in GROUPS:
        keys = sorted(k for k in sd if k.startswith(sub + ".") and "num_batches" not in k
                      and ("running_" in k) == stats)
        out[name] = np.concatenate([np.asarray(sd[k], np.float64).reshape(-1) for k in keys]
                                   or [np.zeros(0)])
    return out


def test_forward_train_matches_jax(init):
    """forward(train=True): outputs within the slice's tolerances; the BN
    running statistics updated in place with momentum 0.1 and the biased
    batch variance, as flax updates them."""
    batch, v = init
    jc, pc = cfgs()
    jm = JaxDeform(config=JaxConfig.from_cfg(jc))
    out, mut = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(batch["img_data"]), jnp.asarray(batch["focus_point"]), train=True,
        rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"]))(v)
    model = port_model(v, pc)
    got = model(torch.from_numpy(batch["img_data"]), torch.from_numpy(batch["focus_point"]),
                train=True, rng=torch.Generator().manual_seed(0))
    assert not model.training  # the call's mode is restored
    assert set(got) == set(out)
    for k in ("xs", "xs_our", "grid", "grid_y"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(out[k]), rtol=0, atol=1e-5)
    _close(got["x_sampled"].detach(), out["x_sampled"], 1e-4, "x_sampled")
    _close(got["pred"].detach(), out["pred"], 5e-4, "pred")
    assert got["pred"].requires_grad
    ref = from_jax_variables(v["params"], jax.tree.map(np.asarray, mut["batch_stats"]))
    old = from_jax_variables(v["params"], v["batch_stats"])
    sd = model.state_dict()
    n_branch3 = 2 * 2 * 2  # batch 2, the coarsest branch at 2x2
    for k, r in ref.items():
        if "running_" in k:
            _close(sd[k], r, 2e-4, k)
    # the coarsest branch's BN (8 values per channel): the unbiased update
    # would move the running variance by 0.1 * vb / 7, far outside the match
    k = "encoder.stage4.0.branches.3.0.bn1.running_var"
    vb = (ref[k].double() - 0.9 * old[k].double()) / 0.1
    unbiased = 0.9 * old[k].double() + 0.1 * vb * n_branch3 / (n_branch3 - 1)
    assert (sd[k].double() - ref[k].double()).abs().max() < 0.1 * (unbiased - ref[k]).abs().max()


def test_dropout_is_live_and_reproducible(init):
    """The port's dropout (the module's patch undone here): a train forward
    depends on its generator's seed and repeats with the same seed; an eval
    forward has none; a train forward without a generator raises."""
    batch, v = init
    _, pc = cfgs()
    model = port_model(v, pc)
    x, f = torch.from_numpy(batch["img_data"]), torch.from_numpy(batch["focus_point"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.Dropout, "forward", LIVE_DROPOUT)
        a = model(x, f, train=True, rng=torch.Generator().manual_seed(5))["pred"]
        b = model(x, f, train=True, rng=torch.Generator().manual_seed(5))["pred"]
        c = model(x, f, train=True, rng=torch.Generator().manual_seed(6))["pred"]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert (a - c).abs().max() > 1e-3
        e1, e2 = model(x, f)["pred"], model(x, f)["pred"]
        torch.testing.assert_close(e1, e2, rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="Generator"):
            model(x, f, train=True)
    # the mask keeps 1 - p of the elements and scales them by 1 / (1 - p)
    d = layers.Dropout(0.3).train()
    with layers.dropout_generator(torch.Generator().manual_seed(0)):
        y = LIVE_DROPOUT(d, torch.ones(200_000))
    assert abs(float((y > 0).float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[y > 0], torch.full_like(y[y > 0], 1 / 0.7))


LIVE_DROPOUT = layers.Dropout.forward


def test_encoder_decoder_backward_matches_jax(init):
    """Train-mode encoder + decoder backward from the same warped image and
    the same upstream gradient: the decoder within 1e-4 of its norm, the
    encoder within 1e-2 (see the module's note)."""
    _, v = init
    jc, pc = cfgs()
    jm = JaxDeform(config=JaxConfig.from_cfg(jc))
    rng = np.random.default_rng(42)
    xs = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    r = rng.normal(size=(2, 16, 16, 51)).astype(np.float32)

    def loss(p):
        pred, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(xs),
                           method=lambda m, x: m.decoder(m.encoder(x, train=True), train=True),
                           mutable=["batch_stats"])
        return jnp.sum(pred * r)

    g = jax.jit(jax.grad(loss))(v["params"])
    ref = from_jax_variables(jax.tree.map(np.asarray, g), {})
    model = port_model(v, pc)
    model.train()
    (model._segment(torch.from_numpy(xs)) * torch.from_numpy(r)).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    for group, tol in (("encoder", 1e-2), ("decoder", 1e-4)):
        ks = sorted(k for k in ref if k.startswith(group + "."))
        assert _rel(np.concatenate([got[k].numpy().ravel() for k in ks]),
                    np.concatenate([ref[k].ravel() for k in ks])) <= tol, group


def _jax_steps(v, jc, batch, n, fix_bn=False):
    """n JAX train steps from ``v``: (losses, params, batch_stats)."""
    jm = JaxDeform(config=JaxConfig.from_cfg(jc))
    tx = jax_create_optimizer(jc)
    state = JaxTrainState(v["params"], v["batch_stats"], tx.init(v["params"]), jnp.int32(0))
    step = jax.jit(jax_make_train_step(jm, tx, JaxLossConfig.from_cfg(jc), fix_bn=fix_bn))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    losses = []
    for _ in range(n):
        state, mets = step(state, jb, jax.random.PRNGKey(1))
        losses.append(float(mets["loss"]))
    return losses, from_jax_variables(jax.tree.map(np.asarray, state.params),
                                      jax.tree.map(np.asarray, state.batch_stats))


def _port_steps(v, pc, batch, n, fix_bn=False):
    model = port_model(v, pc)
    state = S.init_state(model, create_optimizer(pc, model), 0, fix_bn=fix_bn)
    step = S.make_train_step(S.LossConfig.from_cfg(pc), make_stage_schedules(pc), fix_bn=fix_bn)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    losses = [float(step(state, tb)["loss"]) for _ in range(n)]
    assert state.step == n
    return losses, {k: t.detach() for k, t in model.state_dict().items()}


def _compare(v, got, ref, upd_tol: dict | None, stat_tol: float, elem_tol: float | None = None):
    """Per group: the parameter update within ``upd_tol[group]`` of its norm
    (unless ``upd_tol`` is None) and each element within ``elem_tol`` (when
    given); the BN statistics' update within ``stat_tol``."""
    old = from_jax_variables(v["params"], v["batch_stats"])
    for stats in (False, True):
        g, r, o = _by_group(got, stats), _by_group(ref, stats), _by_group(old, stats)
        for name in g:
            if not o[name].size:
                continue
            err = _rel(g[name] - o[name], r[name] - o[name])
            if stats or upd_tol is not None:
                assert err <= (stat_tol if stats else upd_tol[name]), (name, stats, err)
            if elem_tol is not None and not stats:
                assert np.max(np.abs(g[name] - r[name])) <= elem_tol, name


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_one_train_step_matches_jax(init, optim):
    """One step of the default configuration (see the module's note on the
    step's sensitivity for the tolerances)."""
    batch, v = init
    jc, pc = cfgs("TRAIN.optim", optim)
    jl, ref = _jax_steps(v, jc, batch, 1)
    tl, got = _port_steps(v, pc, batch, 1)
    assert abs(tl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    lr = 0.1 * pc.TRAIN.lr_mult_encoder
    if optim == "adam":  # the norm of a sign-like update says nothing: elements only
        _compare(v, got, ref, None, 1e-3, elem_tol=2.01 * lr)
    else:
        _compare(v, got, ref, dict.fromkeys(("encoder", "decoder", "saliency", "compress"), 0.05),
                 1e-3)


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_three_train_steps_match_jax(init, optim):
    """Three consecutive steps where the warped image is bit-equal on both
    sides (uniform 'BI'), all four groups training (joint edge loss)."""
    batch, v = init
    lrm = sum([[f"TRAIN.lr_mult_{g}", "1e-5"] for g in ("encoder", "decoder", "saliency",
                                                         "compress")], [])
    jc, pc = cfgs("TRAIN.optim", optim, "MODEL.uniform_sample", "BI",
                  "TRAIN.deform_joint_loss", "True", *lrm)
    jl, ref = _jax_steps(v, jc, batch, 3)
    tl, got = _port_steps(v, pc, batch, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _compare(v, got, ref, {"encoder": 0.1, "decoder": 0.1, "saliency": 5e-3, "compress": 0.1},
             1e-3)


def test_fix_bn_step_matches_jax(init):
    """TRAIN.fix_bn: the step runs the eval-mode forward with gradients (BN on
    the running statistics, which stay as they were; dropout off): one SGD
    step in the uniform-'BI' configuration, the loss to 1e-5 and each group's
    update to 1e-3 of its norm (eval-mode BN does not amplify the inputs'
    last bits)."""
    batch, v = init
    jc, pc = cfgs("TRAIN.optim", "sgd", "TRAIN.fix_bn", "True", "MODEL.uniform_sample", "BI",
                  "TRAIN.deform_joint_loss", "True")
    jl, ref = _jax_steps(v, jc, batch, 1, fix_bn=True)
    tl, got = _port_steps(v, pc, batch, 1, fix_bn=True)
    assert abs(tl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    _compare(v, got, ref, dict.fromkeys(("encoder", "decoder", "saliency", "compress"), 1e-3),
             0.0)
    old = from_jax_variables(v["params"], v["batch_stats"])
    for k in old:
        if "running_" in k:
            torch.testing.assert_close(got[k], old[k], rtol=0, atol=0)


@pytest.mark.parametrize("scale_by_iter", [False, True])
@pytest.mark.parametrize("pretrain_bol", [True, False])
def test_schedules_equal_jax(scale_by_iter, pretrain_bol):
    """The staged schedules at steps on both sides of each decade boundary
    and of the fix_deform / fix_seg windows: equal to the JAX schedule's f32
    values within f32 rounding (rtol 1e-6), zero exactly where it is zero;
    the group learning rates set before each update are lr_mult times them."""
    opts = ["TRAIN.deform_pretrain", "3", "TRAIN.scale_by_iter", str(scale_by_iter),
            "TRAIN.deform_pretrain_bol", str(pretrain_bol), "TRAIN.fix_deform_aft_pretrain",
            "True", "TRAIN.fix_deform_start_epoch", "4", "TRAIN.fix_deform_end_epoch", "5",
            "TRAIN.opt_deform_LabelEdge", "True", "TRAIN.fix_seg_start_epoch", "7",
            "TRAIN.fix_seg_end_epoch", "7", "TRAIN.epoch_iters", "10"]
    jc, pc = cfgs(*opts)
    js, ps = jax_schedules(jc), make_stage_schedules(pc)
    steps = sorted({s + d for s in range(0, 100, 10) for d in (-1, 0, 1) if s + d >= 0}
                   | {29, 30, 59, 60, 89, 90})
    for key, jfn in (("class", js.lr_class), ("zoom", js.lr_zoom)):
        ref = np.array([float(jfn(jnp.int32(s))) for s in steps])
        got = np.array([ps[key](s) for s in steps])
        np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=key)
        np.testing.assert_array_equal(got == 0.0, ref == 0.0)
    model = DeformSegmentation(DeformConfig.from_cfg(pc), device="cpu")
    opt = create_optimizer(pc, model)
    set_learning_rates(opt, ps, 45)
    for g, (_, _, key, mult) in zip(opt.param_groups, GROUPS):
        assert g["lr"] == getattr(pc.TRAIN, mult) * ps[key](45)


@pytest.mark.parametrize("case", ["default", "stage_window", "after_window", "poly"])
def test_edge_loss_scale_and_running_lrs_equal_jax(case):
    opts = {"default": [],
            "stage_window": ["TRAIN.stage_adjust_edge_loss", "7.0",
                             "TRAIN.adjust_edge_loss_start_epoch", "2",
                             "TRAIN.adjust_edge_loss_end_epoch", "3"],
            "after_window": ["TRAIN.stage_adjust_edge_loss", "7.0",
                             "TRAIN.adjust_edge_loss_start_epoch", "1",
                             "TRAIN.adjust_edge_loss_end_epoch", "1"],
            "poly": ["TRAIN.fixed_edge_loss_scale", "50.0", "TRAIN.edge_loss_pow", "0.9",
                     "TRAIN.edge_loss_scale_min", "3.0"]}[case]
    jc, pc = cfgs(*opts, "TRAIN.num_epoch", "5")
    for epoch in range(1, 6):
        for cur_iter in ((epoch - 1) * 10, epoch * 10 - 1):
            assert edge_loss_scale_at(pc, cur_iter, epoch) == jax_edge_loss_scale_at(
                jc, cur_iter, epoch)
    from fovealseg_tpu.train.optim import poly_running_lrs as jax_poly

    assert poly_running_lrs(pc, 17) == jax_poly(jc, 17)


def test_optimizer_groups():
    """Four groups keyed by sub-network, every parameter in exactly one, each
    with its schedule and lr_mult; Adam with the JAX package's betas and
    weight decay, SGD with momentum beta1."""
    _, pc = cfgs()
    model = DeformSegmentation(DeformConfig.from_cfg(pc), device="cpu")
    opt = create_optimizer(pc, model)
    assert [g["name"] for g in opt.param_groups] == ["encoder", "decoder", "saliency", "compress"]
    assert [g["schedule"] for g in opt.param_groups] == ["class", "class", "zoom", "zoom"]
    ids = [id(p) for g in opt.param_groups for p in g["params"]]
    assert sorted(ids) == sorted(id(p) for p in model.parameters())
    assert isinstance(opt, torch.optim.Adam) and opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["weight_decay"] == pc.TRAIN.weight_decay
    _, pc2 = cfgs("TRAIN.optim", "sgd")
    sgd = create_optimizer(pc2, model)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults["momentum"] == pc2.TRAIN.beta1


def test_make_batch_device_contract():
    """The on-device synthetic batch: shapes and dtypes, the gaze point inside
    its ellipse, the class id in range, the image in [0, 1]; reproducible
    from its generator."""
    a = make_batch_device(torch.Generator().manual_seed(3), 4, 96, 50)
    b = make_batch_device(torch.Generator().manual_seed(3), 4, 96, 50)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["img_data"].shape == (4, 96, 96, 3) and a["img_data"].dtype == torch.float32
    assert a["seg_label"].shape == (4, 96, 96) and a["cls_label"].dtype == torch.int32
    assert 0 <= float(a["img_data"].min()) and float(a["img_data"].max()) <= 1
    assert int(a["cls_label"].min()) >= 0 and int(a["cls_label"].max()) < 50
    fy = torch.round(a["focus_point"][:, 0] * 96).long().clamp(0, 95)
    fx = torch.round(a["focus_point"][:, 1] * 96).long().clamp(0, 95)
    assert bool((a["seg_label"][torch.arange(4), fy, fx] == 1).all())


def test_prefetch_ends_its_worker_when_the_consumer_stops():
    """``prefetch`` keeps the order, raises a worker's exception in the
    consumer, and ends its worker when the consumer stops early."""
    import threading

    assert list(prefetch(iter(range(7)), size=2)) == list(range(7))
    before = threading.active_count()
    gen = prefetch(iter(range(10_000)), size=2)
    assert next(gen) == 0
    gen.close()
    assert threading.active_count() == before

    def boom():
        yield 1
        raise KeyError("worker")

    with pytest.raises(KeyError, match="worker"):
        list(prefetch(boom()))
