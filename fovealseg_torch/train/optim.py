"""The 4-group optimizer and the staged schedules (counterpart of
``fovealseg_tpu/train/optim.py``).

Four parameter groups keyed by submodule, as the reference's four
optimizers: ``encoder`` and ``decoder`` on the "class" schedule,
``saliency`` (``localization``) and ``compress`` (``net_compress``) on the
"zoom" schedule. ``torch.optim.Adam`` (or ``SGD`` with momentum
``TRAIN.beta1``) with ``TRAIN.weight_decay``: PyTorch adds the L2 term to the
gradient before the moments, as ``optax.add_decayed_weights`` does before
``scale_by_adam``. Each group's learning rate is ``lr_mult * schedule(step)``
at the step count before the update, set by :func:`set_learning_rates`.
The fix_deform / fix_seg windows gate a group by a learning rate of 0, so
Adam's moments still accumulate in a window (the JAX package's stated
deviation from the reference, which skips the update).
"""

from __future__ import annotations

import torch

BASE_LR = 0.1
GROUPS = (  # (group name, submodule, schedule, cfg lr_mult key)
    ("encoder", "encoder", "class", "lr_mult_encoder"),
    ("decoder", "decoder", "class", "lr_mult_decoder"),
    ("saliency", "localization", "zoom", "lr_mult_saliency"),
    ("compress", "net_compress", "zoom", "lr_mult_compress"),
)


def make_stage_schedules(cfg) -> dict:
    """{'class': step -> lr factor, 'zoom': step -> lr factor}: the
    decade-decay staged schedule with the fix_seg ('class') and fix_deform
    ('zoom') windows."""
    n_pre = cfg.TRAIN.deform_pretrain
    epoch_iters = cfg.TRAIN.epoch_iters
    scale_by_iter = cfg.TRAIN.scale_by_iter
    pretrain_bol = cfg.TRAIN.deform_pretrain_bol
    fix_deform = (cfg.TRAIN.fix_deform_aft_pretrain, cfg.TRAIN.fix_deform_start_epoch,
                  cfg.TRAIN.fix_deform_end_epoch)
    fix_seg = (cfg.TRAIN.opt_deform_LabelEdge, cfg.TRAIN.fix_seg_start_epoch,
               cfg.TRAIN.fix_seg_end_epoch)

    def _idx_epoch_n(step: int):
        # 1-based epochs; with scale_by_iter the decay counts iterations and
        # the pretrain length scales by epoch_iters
        epoch = step // epoch_iters + 1
        if scale_by_iter:
            return step, epoch, n_pre * epoch_iters
        return epoch, epoch, n_pre

    def _window(lr: float, epoch: int, window) -> float:
        on, s, e = window
        return 0.0 if on and s <= epoch <= e else lr

    def lr_class(step: int) -> float:
        idx, epoch, n = _idx_epoch_n(int(step))
        if pretrain_bol:
            lr = BASE_LR * 0.1 ** (idx // n)
        else:
            shifted = (idx - n) // n if idx >= n else idx // n
            lr = BASE_LR * 0.1 ** shifted
        return _window(lr, epoch, fix_seg)

    def lr_zoom(step: int) -> float:
        idx, epoch, n = _idx_epoch_n(int(step))
        return _window(BASE_LR * 0.1 ** (idx // n), epoch, fix_deform)

    return {"class": lr_class, "zoom": lr_zoom}


def create_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam (``TRAIN.optim`` 'adam') or SGD over the four groups; each group
    carries its ``name``, ``schedule`` and ``lr_mult``."""
    groups = [{"params": list(getattr(model, sub).parameters()), "name": name,
               "schedule": sched, "lr_mult": float(getattr(cfg.TRAIN, mult)), "lr": 0.0}
              for name, sub, sched, mult in GROUPS]
    wd = cfg.TRAIN.weight_decay
    if cfg.TRAIN.optim.lower() == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=(cfg.TRAIN.beta1, 0.999), eps=1e-8,
                                weight_decay=wd)
    return torch.optim.SGD(groups, lr=0.0, momentum=cfg.TRAIN.beta1, weight_decay=wd)


def set_learning_rates(optimizer: torch.optim.Optimizer, schedules: dict, step: int) -> None:
    """Each group's lr = lr_mult * its schedule at ``step`` (the count of
    updates made so far)."""
    for g in optimizer.param_groups:
        g["lr"] = g["lr_mult"] * schedules[g["schedule"]](step)


def edge_loss_scale_at(cfg, cur_iter: int, epoch: int) -> float:
    """The runtime edge-loss scale: the stage window's override, else the
    poly decay of ``TRAIN.fixed_edge_loss_scale`` (when > 0), else the stage
    value after the window (the reference's mutation is sticky), else the
    static ``TRAIN.edge_loss_scale``."""
    t = cfg.TRAIN
    if (t.stage_adjust_edge_loss != 1.0
            and t.adjust_edge_loss_start_epoch <= epoch <= t.adjust_edge_loss_end_epoch):
        return t.stage_adjust_edge_loss
    if t.fixed_edge_loss_scale > 0.0:
        scale = (1.0 - float(cur_iter) / max(t.max_iters, 1)) ** t.edge_loss_pow
        return max(t.fixed_edge_loss_scale * scale, t.edge_loss_scale_min)
    if t.stage_adjust_edge_loss != 1.0 and epoch > t.adjust_edge_loss_end_epoch:
        return t.stage_adjust_edge_loss
    return t.edge_loss_scale


def poly_running_lrs(cfg, cur_iter: int, lr_scale: float = 1.0) -> dict:
    """The running_lr_* values the reference logs: poly decay of the
    configured base LRs (``TRAIN.fov_scale_lr`` multiplies the decay by
    ``lr_scale ** TRAIN.fov_scale_pow``, ``fov_scale_seg_only`` exempts the
    foveater). Logged only; the optimizer never reads them."""
    t = cfg.TRAIN
    scale = (1.0 - float(cur_iter) / max(t.max_iters, 1)) ** t.lr_pow
    if t.fov_scale_lr != "":
        scale *= lr_scale ** t.fov_scale_pow
    fov_scale = scale
    if t.fov_scale_seg_only and t.fov_scale_lr != "":
        fov_scale = scale / (lr_scale ** t.fov_scale_pow)
    return {
        "running_lr_encoder": t.lr_encoder * scale,
        "running_lr_decoder": t.lr_decoder * scale,
        "running_lr_foveater": t.lr_foveater * fov_scale,
    }
