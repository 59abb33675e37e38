"""Epoch driver (counterpart of ``fovealseg_tpu/train/loop.py``): train
epochs, the warped-domain eval, the history CSVs and the checkpoints.

Per-step metrics stay on the device and are drained to the host every
``TRAIN.disp_iter`` steps (one transfer of the stacked pending values), so
the host does not wait for the card each step. Each batch carries the
step's ``edge_scale``, ``edge_only`` (the fix_seg window) and, when the
Recasens pretrain pool can run, ``pool_s``. ``TPU.profile_dir`` records the
first training epoch with ``torch.profiler`` (a Chrome trace there).

Under data parallelism every rank runs the epochs (the steps average their
metrics over the ranks), and rank 0 alone writes the logs, the history
CSVs, the TensorBoard scalars, the visuals, the trace and the checkpoints.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from fovealseg_torch.train import checkpoint as ckpt
from fovealseg_torch.train.optim import edge_loss_scale_at, poly_running_lrs

log = logging.getLogger("fovealseg")

HISTORY = "history_epoch_last_0.csv"
EVAL_HISTORY = "eval_history.csv"


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.n = 0

    def update(self, v, k: int = 1):
        self.sum += float(v) * k
        self.n += k

    def average(self) -> float:
        return self.sum / max(self.n, 1)


def write_history_csv(path: str, rows: list[dict]) -> None:
    """The history CSV: one header from the first row's keys, then the rows."""
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def load_history_csv(path: str, max_epoch: float) -> list[dict]:
    """The rows of an earlier run up to ``max_epoch``, so that a resumed run's
    rewrite extends the curves instead of dropping them."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            vals = {k: (float(v) if v not in ("", None) else "") for k, v in r.items()}
            if float(vals.get("epoch", 0.0)) <= max_epoch:
                rows.append(vals)
    return rows


def _drain(pending: list, keys) -> list[dict]:
    """Host floats of the pending device metrics, in one transfer."""
    if not pending:
        return []
    stacked = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending]).cpu()
    pending.clear()
    return [dict(zip(keys, row.tolist())) for row in stacked]


def batch_controls(cfg, epoch: int, cur_iter: int, pool_rng) -> dict:
    """The per-step entries a batch carries: the edge-loss scale, the
    edge-only flag of the fix_seg window and, when ``deform_pretrain_bol`` is
    off, the pretrain pool size (-1 outside the pretrain/smooth window)."""
    t = cfg.TRAIN
    out = {"edge_scale": edge_loss_scale_at(cfg, cur_iter, epoch),
           "edge_only": bool(t.opt_deform_LabelEdge
                             and t.fix_seg_start_epoch <= epoch <= t.fix_seg_end_epoch)}
    if not t.deform_pretrain_bol:
        pretrain_off = epoch >= t.deform_pretrain and (
            epoch < t.smooth_deform_2nd_start or epoch > t.smooth_deform_2nd_end)
        if pretrain_off:
            out["pool_s"] = -1
        else:
            lo = min(t.saliency_input_size)
            out["pool_s"] = pool_rng.randint(lo // 3, lo)
    return out


def train_one_epoch(train_step: Callable, state, batches: Iterable[dict], epoch: int, cfg,
                    history_rows: Optional[list] = None) -> dict:
    """One epoch of at most ``TRAIN.epoch_iters`` steps; appends the running
    averages per step to ``history_rows``; returns the epoch's means."""
    keys = ("loss", "acc", "edge_loss")
    pending: list = []
    done: list[dict] = []
    tic = time.time()
    i = 0
    for batch in batches:
        cur_iter = i + (epoch - 1) * cfg.TRAIN.epoch_iters
        batch = {**batch, **batch_controls(cfg, epoch, cur_iter, state.pool_rng)}
        pending.append(train_step(state, batch))
        if i % cfg.TRAIN.disp_iter == 0:
            done += _drain(pending, keys)
            lrs = poly_running_lrs(cfg, cur_iter)
            log.info("Epoch: [%d][%d/%d], Time: %.2f, lr_encoder: %.6f, Accuracy: %4.2f, "
                     "Seg_Loss: %.6f, Edge_Loss: %.6f", epoch, i, cfg.TRAIN.epoch_iters,
                     time.time() - tic, lrs["running_lr_encoder"],
                     float(np.mean([d["acc"] for d in done])) * 100,
                     float(np.mean([d["loss"] for d in done])),
                     float(np.mean([d["edge_loss"] for d in done])))
        i += 1
        if i >= cfg.TRAIN.epoch_iters:
            break
    done += _drain(pending, keys)
    if history_rows is not None:
        sums = dict.fromkeys(keys, 0.0)
        for j, d in enumerate(done):
            for k in keys:
                sums[k] += d[k]
            history_rows.append({
                "epoch": epoch - 1 + (j + 1) / cfg.TRAIN.epoch_iters,
                "train_loss": sums["loss"] / (j + 1),
                "train_acc": sums["acc"] / (j + 1),
                "train_edge_loss": sums["edge_loss"] / (j + 1),
            })
    return {k: float(np.mean([d[k] for d in done])) if done else 0.0 for k in keys}


def evaluate_1epoch(eval_step: Callable, state, batches: Iterable[dict],
                    drain_every: int = 16) -> dict:
    """Warped-domain eval: the means of loss, accuracy, edge loss and the
    fg/bin accuracy family over the batches (metrics drained every
    ``drain_every`` batches)."""
    keys = ("loss", "acc", "edge_loss", "acc_bin_fg", "acc_cls_fbg", "acc_bin_fbg")
    meters = {k: AverageMeter() for k in keys}
    pending: list = []

    def _flush():
        for d in _drain(pending, keys):
            for k in keys:
                meters[k].update(d[k])

    for batch in batches:
        pending.append(eval_step(state, batch))
        if len(pending) >= drain_every:
            _flush()
    _flush()
    return {k: m.average() for k, m in meters.items()}


def _profiled(profile_dir: str, fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU, and CUDA where there is a
    card) and write a Chrome trace into ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    path = os.path.join(profile_dir, "train_epoch_trace.json")
    prof.export_chrome_trace(path)
    log.info("torch.profiler trace written to %s", path)
    return out


def fit(cfg, state, train_step: Callable, eval_step: Callable,
        train_loader: Callable[[int], Iterable[dict]], val_loader: Callable[[], Iterable[dict]],
        visual_fn: Optional[Callable] = None):
    """Epochs ``[TRAIN.start_epoch, TRAIN.num_epoch)``: train, checkpoint on
    the cadence (``checkpoint_per_epoch`` and the last epoch; off-cadence
    epochs refresh only the ``_last`` files), eval every ``eval_per_epoch``,
    the history CSVs after each epoch; ``skip_train_for_eval`` evaluates once
    and stops. ``visual_fn(state, epoch)`` runs on the reference's cadence
    (``epoch % 10 == 1``) when ``TRAIN.train_eval_visualise``, on every rank
    (it writes on rank 0). In a process group only rank 0 writes (see the
    module's note). ``TPU.async_checkpoint`` writes each checkpoint in the
    background (``train/checkpoint.py::AsyncSaver``); every write is on disk
    when ``fit`` returns, and a writer's error is raised."""
    import torch.distributed as dist

    from fovealseg_torch.utils.observe import SummaryWriter

    main = not dist.is_initialized() or dist.get_rank() == 0
    ckpt_dir = cfg.DIR
    os.makedirs(ckpt_dir, exist_ok=True)
    resumed = cfg.TRAIN.start_epoch > 0
    history = load_history_csv(os.path.join(ckpt_dir, HISTORY),
                               cfg.TRAIN.start_epoch) if resumed else []
    eval_history = load_history_csv(os.path.join(ckpt_dir, EVAL_HISTORY),
                                    cfg.TRAIN.start_epoch) if resumed else []
    writer = SummaryWriter(os.path.join(ckpt_dir, "tensorboard")) if main else None
    profile_dir = cfg.TPU.profile_dir if main else None
    profiled = False
    # TPU.async_checkpoint: the write overlaps the next epoch (drained at the
    # next save and when fit ends, also when an epoch raises)
    saver = ckpt.AsyncSaver() if cfg.TPU.async_checkpoint else None
    try:
        for epoch0 in range(cfg.TRAIN.start_epoch, cfg.TRAIN.num_epoch):
            epoch = epoch0 + 1
            if not cfg.TRAIN.skip_train_for_eval:
                def run(epoch=epoch):
                    return train_one_epoch(train_step, state, train_loader(epoch), epoch, cfg,
                                           history)
                if profile_dir and not profiled:
                    profiled = True
                    summary = _profiled(profile_dir, run)
                else:
                    summary = run()
                log.info("epoch %d train: %s", epoch, json.dumps(summary))
                if visual_fn is not None and cfg.TRAIN.train_eval_visualise and epoch % 10 == 1:
                    visual_fn(state, epoch)  # every rank: a sharded model's forward is collective
                if main:
                    writer.add_scalar("Loss/train", summary["loss"], epoch)
                    writer.add_scalar("Acc/train", summary["acc"], epoch)
                    writer.add_scalar("edge_loss/train", summary["edge_loss"], epoch)
                if cfg.TRAIN.save_checkpoint:
                    on_cadence = (epoch % cfg.TRAIN.checkpoint_per_epoch == 0
                                  or epoch == cfg.TRAIN.num_epoch)
                    ckpt.save_checkpoint(ckpt_dir, epoch, state, only_last=not on_cadence,
                                         saver=saver)
            if epoch % cfg.TRAIN.eval_per_epoch == 0 or cfg.TRAIN.skip_train_for_eval:
                mets = evaluate_1epoch(eval_step, state, val_loader())
                log.info("epoch %d eval: %s", epoch, json.dumps(mets))
                eval_history.append({"epoch": epoch, **mets})
                if main:
                    for k, v in mets.items():
                        writer.add_scalar(f"{k}/val", v, epoch)
            if main:
                write_history_csv(os.path.join(ckpt_dir, HISTORY), history)
                write_history_csv(os.path.join(ckpt_dir, EVAL_HISTORY), eval_history)
            if cfg.TRAIN.skip_train_for_eval:
                break
    finally:
        if saver is not None:
            saver.close()
    if main:
        writer.close()
    return state
