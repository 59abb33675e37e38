"""Training CLI of the port (counterpart of ``cli/train.py``), on one card.

Usage (the JAX CLI's flags and dotlist grammar, plus ``--device`` and
``--canvas``):

  python -m fovealseg_torch.cli.train --cfg fovealseg_torch/configs/deform.yaml \
      --data synthetic [--device cuda] [--canvas 640] \
      TRAIN.task_input_size '(80,80)' TRAIN.saliency_input_size '(80,80)' \
      MODEL.gaussian_radius 45 DIR ./ckpt/lvis_50cls

One card only: ``--gpus`` naming more than one device, ``TPU.mesh_shape``
with two non-zero dimensions, ``TPU.quantize`` and ``TPU.conv_pack`` raise,
and so does ``--data`` other than ``synthetic``. The synthetic stream is made
on the device (``data/synthetic.py::make_batch_device``): epoch ``e`` draws
from a generator seeded with ``TRAIN.seed + e``, so a resumed run sees the
batches an uninterrupted one would; the eval stream is a fixed held-out set
(``TRAIN.seed + 10000``, 8 batches). Weights come from ``MODEL.weights_*``
when set, else a seeded init; ``TRAIN.start_epoch`` and
``TRAIN.auto_resume`` resume from the port's checkpoint in ``DIR``
(``train/checkpoint.py``). ``MODEL.gt_gradient`` with
``gt_gradient_intrinsic_only`` runs the forward and the metrics with no
backward and no update.
"""

from __future__ import annotations

import argparse
import logging
import os
import re


def refuse_unported(cfg, args) -> None:
    """Raise for every option this single-card CLI does not run."""
    if args.gpus is not None and len(parse_devices(args.gpus)) > 1:
        raise NotImplementedError(
            f"--gpus {args.gpus!r}: data parallelism over several cards is not ported yet "
            "(ROADMAP queue 1, item 5); name one device")
    mesh = tuple(cfg.TPU.mesh_shape)
    if len(mesh) == 2 and all(s > 0 for s in mesh):
        raise NotImplementedError("TPU.mesh_shape with two non-zero dimensions (the 2-D mesh) "
                                  "is not ported (ROADMAP queue 1, item 5)")
    if cfg.TPU.quantize or cfg.TPU.conv_pack:
        raise NotImplementedError(
            "TPU.quantize and TPU.conv_pack are tuned to the TPU's matrix unit and are not "
            "ported (ROADMAP, 'Not to port'); unset them")
    if args.data != "synthetic":
        raise NotImplementedError(
            f"--data {args.data!r}: the LVIS and Cityscapes readers come with the remaining "
            "CLIs (ROADMAP queue 1, item 7); use --data synthetic")


def parse_devices(spec: str) -> list[int]:
    """The reference's device grammar: '0-3', '0,2', 'gpu0,gpu1'."""
    out = []
    for part in spec.split(","):
        part = re.sub(r"^gpu", "", part.strip())
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def _resume(cfg, state, log) -> None:
    """``TRAIN.auto_resume`` (start_epoch 0 and a checkpoint in DIR: resume
    from the newer of ``_last`` and the largest numbered epoch) and
    ``TRAIN.start_epoch > 0`` (epoch N's files, else ``_last``)."""
    from fovealseg_torch.train import checkpoint as ckpt

    d = cfg.DIR
    name = None
    if cfg.TRAIN.start_epoch == 0 and cfg.TRAIN.auto_resume and ckpt.has_checkpoint(d, "last"):
        name = "last"
        ckpt.load_checkpoint(d, name, state)
        cfg.TRAIN.start_epoch = state.step // max(cfg.TRAIN.epoch_iters, 1)
        numbered = [int(m.group(1)) for f in os.listdir(d)
                    if (m := re.fullmatch(r"train_state_epoch_(\d+)\.pth", f))]
        newer = max(numbered, default=0)
        if newer > cfg.TRAIN.start_epoch and ckpt.has_checkpoint(d, newer):
            name = newer
            ckpt.load_checkpoint(d, name, state)
            cfg.TRAIN.start_epoch = state.step // max(cfg.TRAIN.epoch_iters, 1)
        log.info("auto-resume from epoch_%s: start_epoch=%d", name, cfg.TRAIN.start_epoch)
    elif cfg.TRAIN.start_epoch > 0:
        epoch = cfg.TRAIN.start_epoch
        name = epoch if ckpt.has_checkpoint(d, epoch) else "last"
        ckpt.load_checkpoint(d, name, state)
        log.info("resumed from %s epoch_%s at epoch %d (step %d)", d, name, epoch, state.step)


def main(argv=None):
    """Train and return the final ``TrainState``."""
    parser = argparse.ArgumentParser(description="fovealseg training on one CUDA device")
    parser.add_argument("--cfg", required=True, metavar="FILE")
    parser.add_argument("--gpus", default=None, help="one device of the reference grammar")
    parser.add_argument("--data", default="synthetic")
    parser.add_argument("--dataset", default="lvis", choices=["lvis", "cityscapes"])
    parser.add_argument("--image-root", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--canvas", type=int, default=640, help="synthetic canvas size")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    import torch

    from fovealseg_torch import resolve_device
    from fovealseg_torch.configs import audit_dead_keys, get_default_cfg
    from fovealseg_torch.data.loader import prefetch
    from fovealseg_torch.data.synthetic import make_batch_device
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.checkpoint import load_torch_weight_files
    from fovealseg_torch.train.loop import fit
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules
    from fovealseg_torch.utils.summary import summarize

    device = resolve_device(args.device)
    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    refuse_unported(cfg, args)
    if device.type == "cuda" and args.gpus:
        device = torch.device("cuda", parse_devices(args.gpus)[0])
    if cfg.TRAIN.auto_batch == "auto10":
        # ~0.65M pixels per device; epoch_iters = one pass of the list file
        cfg.TRAIN.batch_size_per_gpu = max(1, int((1e6 * 0.65) // (cfg.DATASET.imgSizes[0] ** 2)))
        cfg.TRAIN.num_gpus = 1
        if os.path.isfile(cfg.DATASET.list_train):
            with open(cfg.DATASET.list_train) as fh:
                num_data = sum(1 for _ in fh)
            cfg.TRAIN.epoch_iters = max(1, num_data // cfg.TRAIN.batch_size_per_gpu)
    cfg.TRAIN.max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch

    os.makedirs(cfg.DIR, exist_ok=True)
    log = logging.getLogger("fovealseg")
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s")
    handlers = [logging.StreamHandler(), logging.FileHandler(os.path.join(cfg.DIR, "train.log"))]
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        log.info("config:\n%s", cfg.dump())
        audit_dead_keys(cfg, log)
        # convs: TF32 in f32 on the card, set explicitly (the grid solver and
        # the resizes run full f32 matmuls whatever this says)
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        log.info("convs: cudnn fp32 precision %s", torch.backends.cudnn.conv.fp32_precision)

        dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bfloat16" else torch.float32
        model = DeformSegmentation(DeformConfig.from_cfg(cfg), dtype=dtype, device=device)
        init_weights(model, torch.Generator().manual_seed(cfg.TRAIN.seed))
        files = {"encoder": cfg.MODEL.weights_encoder, "decoder": cfg.MODEL.weights_decoder,
                 "saliency": cfg.MODEL.weights_net_saliency,
                 "compress": cfg.MODEL.weights_net_compress}
        if any(files.values()):
            log.info("loaded torch weights: %s", load_torch_weight_files(model, files))
        log.info("model summary:\n%s", summarize(model))
        lcfg = S.LossConfig.from_cfg(cfg)
        state = S.init_state(model, create_optimizer(cfg, model), cfg.TRAIN.seed,
                             fix_bn=cfg.TRAIN.fix_bn)
        _resume(cfg, state, log)

        if cfg.MODEL.gt_gradient and cfg.MODEL.gt_gradient_intrinsic_only:
            train_step = S.make_forward_only_step(lcfg, fix_bn=cfg.TRAIN.fix_bn)
            log.info("gt_gradient_intrinsic_only: optimizer updates disabled")
        else:
            train_step = S.make_train_step(lcfg, make_stage_schedules(cfg),
                                           fix_bn=cfg.TRAIN.fix_bn)
        eval_step = S.make_eval_step(lcfg)
        batch_size = cfg.TRAIN.batch_size_per_gpu
        num_fg = cfg.DATASET.num_class - 1

        def stream(seed: int, n: int):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            for _ in range(n):
                yield make_batch_device(gen, batch_size, args.canvas, num_fg)

        def train_loader(epoch):
            return prefetch(stream(cfg.TRAIN.seed + epoch, cfg.TRAIN.epoch_iters))

        def val_loader():
            return stream(cfg.TRAIN.seed + 10_000, 8)

        def visual_fn(state, epoch):
            from fovealseg_torch.utils.visuals import collect_deform_visuals, dump_batch_visuals

            vis = collect_deform_visuals(state.model, next(iter(val_loader())),
                                         cfg.DATASET.num_class)
            out_dir = os.path.join(cfg.DIR, f"train_visual_epoch{epoch}")
            paths = dump_batch_visuals(out_dir, vis, num_classes=cfg.DATASET.num_class)
            log.info("wrote %d train visuals to %s", len(paths), out_dir)

        state = fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                    visual_fn=visual_fn if cfg.TRAIN.train_eval_visualise else None)
        log.info("Training Done!")
        return state
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
