"""Train and eval steps (counterpart of ``fovealseg_tpu/train/step.py``).

``compute_losses`` assembles the training loss as the JAX package does:
the label warped through ``grid_y`` and truncated to ids, the ground truth
``y * cls + (1 - y) * bg``, Dice + Focal(gamma=5) + the joint edge loss
(optional entropy regulariser), and the warped-domain accuracy family.

The state is a :class:`TrainState`: the model, its optimizer, the step
count, the dropout generator and the pretrain-pool draw. A train step
sets each parameter group's learning rate from the schedule at the step
count before the update (as optax's ``scale_by_schedule`` counts), runs the
training forward with gradients, the backward and the optimizer's update, in
place. Metrics are 0-d tensors on the model's device; nothing here waits
for the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import warnings

import torch
import torch.distributed as dist

from fovealseg_torch.core import losses as L
from fovealseg_torch.core import metrics as M
from fovealseg_torch.core.edges import edge_target_pil_style
from fovealseg_torch.core.interpolate import resize_area, resize_bilinear, resize_nearest
from fovealseg_torch.core.warp import grid_sample
from fovealseg_torch.models.layers import batch_block


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model (parameters and BN statistics),
    its optimizer, the step count, the dropout generator (on the model's
    device) and the host generator of the pretrain pool size; ``mesh``
    (``parallel/mesh.py::Mesh2D``) when the model is sharded over a 2-D
    mesh (the checkpoints then gather and slice its shards)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    pool_rng: random.Random
    mesh: object = None


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss knobs from the cfg tree (the JAX package's fields)."""

    num_class: int = 51
    edge_loss_scale: float = 100.0
    edge_norm: bool = True  # TRAIN.opt_deform_LabelEdge_norm
    deform_joint_loss: bool = True
    focal_gamma: float = 5.0
    entropy_reg_weight: float = 0.0  # TRAIN.entropy_regularisation(_weight)
    edge_target_softmax: bool = False  # TRAIN.opt_deform_LabelEdge_softmax
    edge_zero_bound: int = 0  # TRAIN.deform_zero_bound(_factor)
    edge_blur_radius: float = 1.0  # MODEL.gt_grad_gaussian_blur_r
    saliency_hw: tuple = (80, 80)
    uniform_bi: bool = False  # MODEL.uniform_sample == 'BI': plain label downsample
    # a step's loss may leave parameters unreached: the fix_seg window trains
    # on the edge loss alone, and an override or a uniform grid cuts the
    # warp off the saliency nets (DDP then searches for them each step)
    unused_parameters: bool = True

    @classmethod
    def from_cfg(cls, cfg) -> "LossConfig":
        return cls(
            num_class=cfg.DATASET.num_class,
            edge_loss_scale=cfg.TRAIN.edge_loss_scale,
            edge_norm=cfg.TRAIN.opt_deform_LabelEdge_norm,
            deform_joint_loss=cfg.TRAIN.deform_joint_loss,
            focal_gamma=5.0,  # hard-coded in the reference
            entropy_reg_weight=(cfg.TRAIN.entropy_regularisation_weight
                                if cfg.TRAIN.entropy_regularisation else 0.0),
            edge_target_softmax=cfg.TRAIN.opt_deform_LabelEdge_softmax,
            edge_zero_bound=(cfg.TRAIN.deform_zero_bound_factor
                             if cfg.TRAIN.deform_zero_bound else 0),
            edge_blur_radius=float(cfg.MODEL.gt_grad_gaussian_blur_r),
            saliency_hw=tuple(cfg.TRAIN.saliency_input_size),
            uniform_bi=cfg.MODEL.uniform_sample == "BI",
            unused_parameters=bool(
                (cfg.TRAIN.opt_deform_LabelEdge
                 and cfg.TRAIN.fix_seg_start_epoch <= min(cfg.TRAIN.fix_seg_end_epoch,
                                                          cfg.TRAIN.num_epoch))
                or cfg.MODEL.gt_gradient or cfg.MODEL.uniform_sample),
        )


def compute_losses(out: dict, batch: dict, lcfg: LossConfig, edge_scale=None, reduce=None):
    """out: the ``DeformSegmentation`` forward dict; batch: ``seg_label``
    [B, H, W] binary mask, ``cls_label`` [B] int, optionally ``edge_scale``
    (a float overriding ``TRAIN.edge_loss_scale``) and ``edge_only`` (a bool:
    the step trains on the edge loss alone, the ``fix_seg`` window).
    Returns (loss, metrics dict of detached 0-d tensors).

    ``reduce`` (``parallel/mesh.py::BatchReduce``, the 2-D mesh): ``out`` and
    ``batch`` are this rank's block of the global batch, and the loss and
    the metrics are the global batch's (Dice's per-class sums, the edge
    loss's extrema and every mean taken over the data group). A rank's
    gradient then reaches only its own block, and the ranks' gradients sum
    to the global one."""
    avg = (lambda t: t) if reduce is None else reduce.avg
    y = batch["seg_label"].to(torch.float32)
    cls = batch["cls_label"].to(torch.int32).reshape(-1)
    xs = out["xs"]
    pred = out["pred"].to(torch.float32)
    bg = lcfg.num_class - 1

    gh, gw = xs.shape[1], xs.shape[2]
    if lcfg.edge_norm:
        xs_target = resize_area(y[..., None], (gh, gw))
    else:
        xs_target = edge_target_pil_style(
            y, lcfg.saliency_hw, (gh, gw), lcfg.edge_blur_radius,
            softmax=lcfg.edge_target_softmax, zero_bound=lcfg.edge_zero_bound)
    if edge_scale is None:
        edge_scale = batch.get("edge_scale")
    scale = lcfg.edge_loss_scale if edge_scale is None else edge_scale
    # the norm edge loss trains on the saliency before the overrides, so the
    # saliency nets keep learning under gt_gradient / uniform overrides
    xs_edge = out.get("xs_our", xs) if lcfg.edge_norm else xs
    e_loss = L.edge_loss(xs_edge, xs_target, scale, lcfg.edge_norm, reduce=reduce)

    grid_y = out["grid_y"].detach()  # the labels below are truncated ids: no gradient
    if lcfg.uniform_bi:
        y_sampled = resize_bilinear(y[..., None], (grid_y.shape[1], grid_y.shape[2]))[..., 0]
    else:
        y_sampled = grid_sample(y[..., None], grid_y)[..., 0]
    label = y_sampled.to(torch.int32)
    gt = label * cls[:, None, None] + (1 - label) * bg

    if "pred_hr" in out:
        # MODEL.loss_at_high_res: the seg loss on the full-res prediction
        pred_hr = out["pred_hr"].to(torch.float32)
        y_hr = y
        if tuple(y.shape[1:3]) != tuple(pred_hr.shape[1:3]):
            y_hr = resize_nearest(y[..., None], tuple(pred_hr.shape[1:3]))[..., 0]
        label_hr = y_hr.to(torch.int32)
        loss_pred, loss_gt = pred_hr, label_hr * cls[:, None, None] + (1 - label_hr) * bg
    else:
        loss_pred, loss_gt = pred, gt

    focal = L.focal_loss(loss_pred, loss_gt, lcfg.focal_gamma, reduce=reduce)
    dice = L.dice_loss_multiclass(loss_pred, loss_gt, reduce=reduce)
    loss = dice + focal
    if lcfg.deform_joint_loss:
        loss = loss + e_loss
    if lcfg.entropy_reg_weight:
        p_flat = xs.reshape(xs.shape[0], -1)
        ent = -torch.sum(p_flat * torch.log(p_flat + 1e-12), dim=-1)
        loss = loss - lcfg.entropy_reg_weight * avg(torch.mean(ent))

    with torch.no_grad():
        acc = avg(M.pixel_acc(loss_pred, loss_gt, bg))
    if batch.get("edge_only"):
        # the fix_seg window: the step trains on the edge loss alone and logs
        # the (degenerate) edge accuracy, as the reference does
        loss = e_loss
        tgt_acc = (L.minmax_normalize(xs_target, reduce=reduce) if lcfg.edge_norm
                   else xs_target)
        acc = avg(torch.mean((torch.floor(tgt_acc) == 0.0).to(torch.float32)))

    with torch.no_grad():
        mets = {
            "loss": loss.detach(),
            "dice_loss": dice.detach(),
            "focal_loss": focal.detach(),
            "edge_loss": e_loss.detach(),
            "acc": acc.detach(),
            "acc_bin_fg": avg(M.fg_bin_pixel_acc(loss_pred, loss_gt, bg)),
            "acc_cls_fbg": avg(M.fbg_cls_pixel_acc(loss_pred, loss_gt, bg)),
            "acc_bin_fbg": avg(M.fbg_bin_pixel_acc(loss_pred, loss_gt, bg)),
        }
    return loss, mets


def _forward(model, batch: dict, train: bool, grad: bool, rng: torch.Generator) -> dict:
    y = batch["seg_label"] if model.config.gt_gradient else None
    return model(batch["img_data"], batch["focus_point"], train=train, y=y,
                 pool_s=batch.get("pool_s"), rng=rng, grad=grad)


class LossForward(torch.nn.Module):
    """The training forward and the loss as one module, the unit that DDP
    wraps: its search for parameters the loss does not reach then starts
    from the loss alone (the forward's other outputs reach every network)."""

    def __init__(self, model: torch.nn.Module, lcfg: LossConfig):
        super().__init__()
        self.model = model
        self.lcfg = lcfg

    def forward(self, batch: dict, rng: torch.Generator, train: bool):
        return compute_losses(_forward(self.model, batch, train, True, rng), batch, self.lcfg)


def mean_over_ranks(mets: dict, group) -> dict:
    """The metrics averaged over the ranks of ``group`` (one all-reduce of
    the stacked f32 values), as ``pmean`` averages them."""
    keys = list(mets)
    t = torch.stack([mets[k].to(torch.float32) for k in keys])
    dist.all_reduce(t, group=group)
    t = t / dist.get_world_size(group)
    return dict(zip(keys, t.unbind()))


def ddp(module: torch.nn.Module, group, find_unused: bool):
    """``module`` under ``DistributedDataParallel``: gradients averaged over
    ``group``; buffers not broadcast at each forward (each rank keeps the BN
    statistics it computes, as each JAX replica does; with cross-rank BN
    they are equal anyway); with ``find_unused`` the parameters that the
    loss does not reach are found each step."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(module.parameters()).device
    with warnings.catch_warnings():
        # newer releases rename the flag; the old name keeps the meaning here
        warnings.filterwarnings("ignore", message=".*broadcast_buffers", category=FutureWarning)
        return DistributedDataParallel(module, device_ids=[dev] if dev.type == "cuda" else None,
                                       process_group=group, broadcast_buffers=False,
                                       find_unused_parameters=find_unused)


def make_train_step(lcfg: LossConfig, schedules, fix_bn: bool = False, group=None, mesh=None):
    """Returns ``train_step(state, batch) -> metrics``, which updates
    ``state`` in place. ``schedules`` maps a group's ``schedule`` key to
    ``step -> lr factor`` (``train/optim.py``).

    ``fix_bn`` (``TRAIN.fix_bn``): the reference trains with the module in
    eval mode, so BN uses (and never updates) the running statistics and
    dropout is off, while gradients still flow.

    ``group`` (a process group): the data-parallel step of
    ``parallel/mesh.py``. ``batch`` is this rank's block; the forward and
    the loss run under DDP, made around ``state.model`` at the first call,
    which averages the gradients over the group (and searches for unreached
    parameters only under ``lcfg.unused_parameters``); the metrics are
    averaged over the group too.

    ``mesh`` (a ``parallel/mesh.py::Mesh2D``, the model sharded by
    ``shard_model_2d``): the counterpart of the JAX package's
    ``make_gspmd_train_step``, the one-process step on the global batch.
    ``batch`` is this data index's block; dropout draws the global batch's
    mask; the loss and the metrics are the global batch's
    (``compute_losses(..., reduce=)``); the gradients are summed over the
    data group (``parallel/mesh.py::sum_gradients``) and the optimizer
    updates this rank's shards."""
    from fovealseg_torch.parallel import mesh as mesh_lib
    from fovealseg_torch.train.optim import set_learning_rates

    wrapped: dict = {}

    def train_step(state: TrainState, batch: dict) -> dict:
        set_learning_rates(state.optimizer, schedules, state.step)
        if mesh is not None:
            with batch_block(mesh.data_index, mesh.dp):
                out = _forward(state.model, batch, not fix_bn, True, state.generator)
            loss, mets = compute_losses(out, batch, lcfg, reduce=mesh.reduce)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh_lib.sum_gradients(state.model, mesh.data_group)
            state.optimizer.step()
            state.step += 1
            return mets
        if group is None:
            out = _forward(state.model, batch, not fix_bn, True, state.generator)
            loss, mets = compute_losses(out, batch, lcfg)
        else:
            if wrapped.get("model") is not state.model:
                wrapped.update(model=state.model, ddp=ddp(LossForward(state.model, lcfg), group,
                                                         lcfg.unused_parameters))
            loss, mets = wrapped["ddp"](batch, state.generator, not fix_bn)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return mets if group is None else mean_over_ranks(mets, group)

    return train_step


def make_forward_only_step(lcfg: LossConfig, fix_bn: bool = False, group=None, mesh=None):
    """``MODEL.gt_gradient_intrinsic_only``: the training forward and the
    metrics, no backward and no update (BN running statistics still update
    unless ``fix_bn``); the step count advances. With a process group the
    metrics are averaged over it; with a 2-D ``mesh`` they are the global
    batch's."""

    def forward_only_step(state: TrainState, batch: dict) -> dict:
        with (batch_block(mesh.data_index, mesh.dp) if mesh is not None
              else contextlib.nullcontext()):
            out = _forward(state.model, batch, not fix_bn, False, state.generator)
        _, mets = compute_losses(out, batch, lcfg, reduce=None if mesh is None else mesh.reduce)
        state.step += 1
        return mets if group is None else mean_over_ranks(mets, group)

    return forward_only_step


def make_eval_step(lcfg: LossConfig, group=None, mesh=None):
    """Warped-domain eval step: the eval forward and the loss/accuracy
    metrics, without gradients; with a process group, averaged over it; with
    a 2-D ``mesh`` (the counterpart of ``make_gspmd_eval_step``), the global
    batch's."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        out = _forward(state.model, batch, False, False, state.generator)
        _, mets = compute_losses(out, batch, lcfg, reduce=None if mesh is None else mesh.reduce)
        return mets if group is None else mean_over_ranks(mets, group)

    return eval_step


def init_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, seed: int,
               fix_bn: bool = False, mesh=None) -> TrainState:
    """A fresh state at step 0: the model put in train mode (eval mode under
    ``fix_bn``), the dropout generator on the model's device seeded with
    ``seed``, the pool draw's host generator too. ``mesh``: the 2-D mesh the
    model is sharded over (every rank keeps the same generator)."""
    model.train(not fix_bn)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(model, optimizer, 0, gen, random.Random(seed), mesh)
