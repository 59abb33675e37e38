"""Training CLI of the port (counterpart of ``cli/train.py``).

Usage (the JAX CLI's flags and dotlist grammar, plus ``--device``,
``--backend`` and ``--canvas``):

  python -m fovealseg_torch.cli.train --cfg fovealseg_torch/configs/deform.yaml \
      --data synthetic [--gpus 0-3] [--device cuda] [--canvas 640] \
      TRAIN.task_input_size '(80,80)' TRAIN.saliency_input_size '(80,80)' \
      MODEL.gaussian_radius 45 DIR ./ckpt/lvis_50cls

``--gpus`` naming N > 1 devices trains data-parallel (``parallel/``): N
rank processes started by ``parallel/launch.py``, one per card over NCCL
(``--device cpu``: N CPU processes over gloo; ``--backend gloo`` on cards).
The global batch is ``TRAIN.batch_size_per_gpu x N``; ``TRAIN.auto_batch
auto10`` counts N devices, as the JAX CLI does. Cross-rank BN follows
``TPU.sync_bn`` when N > 1. Rank 0 logs, writes the history and the
checkpoints; every rank loads them.

``TPU.mesh_shape '(dp,mp)'`` with two non-zero dimensions trains on the 2-D
(data, model) mesh (``parallel/mesh.py``, the JAX CLI's GSPMD step): dp * mp
ranks, the wide weights sharded over the mp ranks of each data index
(``parallel/tensor_parallel.py``), the one-process step on the global batch
of ``TRAIN.batch_size_per_gpu x dp x mp`` (BN over the global batch whatever
``TPU.sync_bn`` says), and the eval stream through the 2-D eval step. As in
the JAX CLI, ``--gpus`` does not size it: without ``--gpus`` rank r runs on
``cuda:r``; ``--gpus`` may name one card per rank (``--gpus 0,0,0,0
--backend gloo`` puts four ranks on one card). ``auto10`` counts dp * mp
devices. Checkpoints hold the gathered (one-process) tensors, written by
rank 0, and each rank loads its shards of them. ``TPU.quantize`` and
``TPU.conv_pack`` raise.

``--data <cook root>`` trains on a cooked set (``python -m
fovealseg_torch.cli.cook``): ``--dataset lvis`` (with ``--image-root`` for
the JPEGs) or ``cityscapes``, the ``train`` and ``valid`` partitions under
``DATASET.dataset_marker_{train,valid}``. As in the JAX CLI, an epoch is one
pass over the train partition: ``TRAIN.epoch_iters`` is set to it (with a
warning) before the optimizer is built, and a set smaller than the global
batch exits. Epoch ``e`` shuffles with ``TRAIN.seed + e``; each rank reads
only its contiguous block of each global batch, in the prefetch thread, into
pinned host memory, and copies it to the card with ``non_blocking=True``.

``--data synthetic`` (the default): the stream is made
on the device (``data/synthetic.py::make_batch_device``): epoch ``e`` draws
the global batch from a generator seeded with ``TRAIN.seed + e`` and each
rank keeps its contiguous block (``parallel/mesh.py::shard_batch``), so a resumed run sees the batches an uninterrupted one would and
N ranks see the batches of one process at the global batch; the eval stream
is a fixed held-out set (``TRAIN.seed + 10000``, 8 batches). Weights come
from ``MODEL.weights_*`` when set, else a seeded init; ``TRAIN.start_epoch`` and
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


def refuse_unported(cfg) -> None:
    """Raise for every option this CLI does not run."""
    if cfg.TPU.quantize or cfg.TPU.conv_pack:
        raise NotImplementedError(
            "TPU.quantize and TPU.conv_pack are tuned to the TPU's matrix unit and are not "
            "ported (ROADMAP, 'Not to port'); unset them")


def mesh_2d(cfg) -> tuple[int, int] | None:
    """(dp, mp) when ``TPU.mesh_shape`` selects the 2-D mesh (two non-zero
    dimensions), else None."""
    shape = tuple(cfg.TPU.mesh_shape)
    return (int(shape[0]), int(shape[1])) if len(shape) == 2 and all(s > 0 for s in shape) else None


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
    from the newer of ``_last`` and the largest complete numbered epoch; a
    ``_last`` set that an interrupted write left incomplete is skipped) and
    ``TRAIN.start_epoch > 0`` (epoch N's files, else ``_last``)."""
    from fovealseg_torch.train import checkpoint as ckpt

    d = cfg.DIR
    if cfg.TRAIN.start_epoch == 0 and cfg.TRAIN.auto_resume:
        numbered = [int(m.group(1)) for f in (os.listdir(d) if os.path.isdir(d) else [])
                    if (m := re.fullmatch(r"train_state_epoch_(\d+)\.pth", f))]
        newest = max((n for n in numbered if ckpt.has_checkpoint(d, n)), default=0)
        name = None
        if ckpt.has_checkpoint(d, "last"):
            name = "last"
            ckpt.load_checkpoint(d, name, state)
            cfg.TRAIN.start_epoch = state.step // max(cfg.TRAIN.epoch_iters, 1)
        if newest > cfg.TRAIN.start_epoch:
            name = newest
            ckpt.load_checkpoint(d, name, state)
            cfg.TRAIN.start_epoch = state.step // max(cfg.TRAIN.epoch_iters, 1)
        if name is not None:
            log.info("auto-resume from epoch_%s: start_epoch=%d", name, cfg.TRAIN.start_epoch)
    elif cfg.TRAIN.start_epoch > 0:
        epoch = cfg.TRAIN.start_epoch
        name = epoch if ckpt.has_checkpoint(d, epoch) else "last"
        ckpt.load_checkpoint(d, name, state)
        log.info("resumed from %s epoch_%s at epoch %d (step %d)", d, name, epoch, state.step)


def main(argv=None):
    """Train. One process: return the final ``TrainState``. Several ranks
    (``--gpus`` naming N > 1 devices, or the 2-D mesh): start them, and
    return each rank's summary (``step``, ``topology``) in rank order."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args, cfg = _parse(argv)
    devices = parse_devices(args.gpus) if args.gpus else []
    grid = mesh_2d(cfg)
    if grid is not None:
        n = grid[0] * grid[1]
        if devices and len(devices) != n:
            raise ValueError(f"TPU.mesh_shape {grid} runs {n} ranks, and --gpus names "
                             f"{len(devices)} devices: name one per rank, or leave --gpus out")
        devices = devices or list(range(n))
    if len(devices) > 1:
        from fovealseg_torch.parallel.launch import run_workers

        n = len(devices)
        cpu = args.device == "cpu"
        return run_workers(n, _rank_main, argv, device="cpu" if cpu else devices,
                           backend=args.backend, timeout=args.timeout, echo=True,
                           threads=max(1, (os.cpu_count() or 1) // n) if cpu else None)
    return _train(args, cfg, None)


def _rank_main(rank, argv):
    """One rank of a data-parallel run."""
    from fovealseg_torch.parallel.multihost import describe_topology

    args, cfg = _parse(argv)
    state = _train(args, cfg, rank)
    return {"step": state.step, "topology": describe_topology(rank.device)}


def _parse(argv):
    parser = argparse.ArgumentParser(description="fovealseg training on CUDA devices")
    parser.add_argument("--cfg", required=True, metavar="FILE")
    parser.add_argument("--gpus", default=None,
                        help="devices of the reference grammar ('0-3', '0,2'); N > 1 trains "
                             "data-parallel over N ranks")
    parser.add_argument("--data", default="synthetic")
    parser.add_argument("--dataset", default="lvis", choices=["lvis", "cityscapes"])
    parser.add_argument("--image-root", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="the ranks' backend (default: NCCL on cards, gloo on the CPU)")
    parser.add_argument("--timeout", type=float, default=24 * 3600.0,
                        help="deadline of a data-parallel run, in seconds")
    parser.add_argument("--canvas", type=int, default=640,
                        help="the synthetic canvas, or the cooked LVIS set's (640, as the JAX "
                             "CLI's reader assumes)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    refuse_unported(cfg)
    return args, cfg


def host_to_device(a, device):
    """A numpy array on ``device``: on a card through pinned host memory and
    a copy that does not block the host."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _readers(args, cfg, global_batch: int, log):
    """The cooked ``train`` and ``valid`` readers of ``--data``, with
    ``TRAIN.epoch_iters`` set to one pass over the train partition (and
    ``TRAIN.max_iters`` after it). A training id that does not fit
    ``DATASET.num_class`` raises; a set smaller than the global batch
    exits."""
    if args.dataset == "cityscapes":
        from fovealseg_torch.data.cityscapes import DatasetCityscapes

        train_ds = DatasetCityscapes(os.path.join(args.data, "train"),
                                     marker=cfg.DATASET.dataset_marker_train)
        val_ds = DatasetCityscapes(os.path.join(args.data, "valid"),
                                   marker=cfg.DATASET.dataset_marker_valid)
        log.info("Cityscapes cooked data: %d train / %d val", len(train_ds), len(val_ds))
    else:
        from fovealseg_torch.data.lvis import DatasetLVIS

        train_ds = DatasetLVIS(os.path.join(args.data, "train"), args.image_root,
                               canvas=args.canvas, marker=cfg.DATASET.dataset_marker_train)
        val_ds = DatasetLVIS(os.path.join(args.data, "valid"), args.image_root,
                             canvas=args.canvas, marker=cfg.DATASET.dataset_marker_valid)
        log.info("LVIS cooked data: %d train / %d val", len(train_ds), len(val_ds))
    from fovealseg_torch.data.loader import check_class_ids

    for part, ds in (("train", train_ds), ("valid", val_ds)):
        check_class_ids(ds.class_ids(), cfg.DATASET.num_class,
                        f"--data {args.data} ({args.dataset} {part})")
    # an epoch is one pass over the train partition, as in the reference; the
    # LR schedule and auto-resume's step // epoch_iters count in those epochs
    steps_per_epoch = len(train_ds) // max(global_batch, 1)
    if steps_per_epoch == 0 or len(val_ds) < global_batch:
        raise SystemExit(
            f"cooked set too small for the global batch: {len(train_ds)} train / "
            f"{len(val_ds)} val samples but batch_size_per_gpu={cfg.TRAIN.batch_size_per_gpu} x "
            f"{global_batch // cfg.TRAIN.batch_size_per_gpu} devices = {global_batch}; reduce "
            f"the batch or the device count (--gpus)")
    if steps_per_epoch != cfg.TRAIN.epoch_iters:
        log.warning("TRAIN.epoch_iters=%d but the cooked train set yields %d batches/epoch: "
                    "using %d so the LR schedule and resume accounting stay in step",
                    cfg.TRAIN.epoch_iters, steps_per_epoch, steps_per_epoch)
        cfg.TRAIN.epoch_iters = steps_per_epoch
        cfg.TRAIN.max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch
    return train_ds, val_ds


def _train(args, cfg, rank):
    """Train on one process (``rank`` None) or as one rank of several."""
    import torch
    import torch.distributed as dist

    from fovealseg_torch import resolve_device
    from fovealseg_torch.configs import audit_dead_keys
    from fovealseg_torch.data.loader import prefetch
    from fovealseg_torch.data.synthetic import make_batch_device
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import convert_sync_bn, init_weights
    from fovealseg_torch.parallel.mesh import (make_mesh_2d, replicate_state, shard_batch,
                                               shard_model_2d)
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.checkpoint import load_torch_weight_files
    from fovealseg_torch.train.loop import fit
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules
    from fovealseg_torch.utils.summary import summarize

    if rank is None:
        device, r, world, group = resolve_device(args.device), 0, 1, None
        if device.type == "cuda" and args.gpus:
            device = torch.device("cuda", parse_devices(args.gpus)[0])
    else:
        device, r, world, group = rank.device, rank.rank, rank.world_size, dist.group.WORLD
    grid = mesh_2d(cfg)
    mesh = None
    # the batch is split over the data indices: one block per rank (1-D), per
    # data index (2-D)
    block, blocks = r, world
    if grid is not None and grid[0] * grid[1] > 1:  # a 1x1 mesh is the one-process step
        if world != grid[0] * grid[1]:
            raise ValueError(f"TPU.mesh_shape {grid} needs {grid[0] * grid[1]} ranks, "
                             f"this run has {world}")
        mesh = make_mesh_2d(*grid)
        group = None
        block, blocks = mesh.data_index, mesh.dp
    if cfg.TRAIN.auto_batch == "auto10":
        # ~0.65M pixels per device; epoch_iters = one pass of the list file over the devices
        cfg.TRAIN.batch_size_per_gpu = max(1, int((1e6 * 0.65) // (cfg.DATASET.imgSizes[0] ** 2)))
        cfg.TRAIN.num_gpus = world
        if os.path.isfile(cfg.DATASET.list_train):
            with open(cfg.DATASET.list_train) as fh:
                num_data = sum(1 for _ in fh)
            cfg.TRAIN.epoch_iters = max(1, num_data // (world * cfg.TRAIN.batch_size_per_gpu))
    cfg.TRAIN.max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch

    os.makedirs(cfg.DIR, exist_ok=True)
    log = logging.getLogger("fovealseg")
    log.setLevel(logging.INFO if r == 0 else logging.WARNING)
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s")
    handlers = [logging.StreamHandler()]
    if r == 0:
        handlers.append(logging.FileHandler(os.path.join(cfg.DIR, "train.log")))
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    try:
        log.info("config:\n%s", cfg.dump())
        if r == 0:
            audit_dead_keys(cfg, log)
        global_batch = cfg.TRAIN.batch_size_per_gpu * world
        if args.data != "synthetic":
            # before the optimizer: the stage schedules read TRAIN.epoch_iters
            train_ds, val_ds = _readers(args, cfg, global_batch, log)
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
        if mesh is not None:
            log.info("2-D mesh: dp=%d x mp=%d over %s, %d layers sharded over 'model', BN over "
                     "the global batch", mesh.dp, mesh.mp, dist.get_backend(),
                     shard_model_2d(model, mesh))
        elif world > 1 and cfg.TPU.sync_bn:
            log.info("cross-rank BN on %d layers", convert_sync_bn(model, group))
        lcfg = S.LossConfig.from_cfg(cfg)
        state = S.init_state(model, create_optimizer(cfg, model), cfg.TRAIN.seed,
                             fix_bn=cfg.TRAIN.fix_bn, mesh=mesh)
        _resume(cfg, state, log)
        if group is not None:
            replicate_state(state, group)
            log.info("data parallel: %d ranks over %s, global batch %d", world,
                     dist.get_backend(group), cfg.TRAIN.batch_size_per_gpu * world)

        if cfg.MODEL.gt_gradient and cfg.MODEL.gt_gradient_intrinsic_only:
            train_step = S.make_forward_only_step(lcfg, fix_bn=cfg.TRAIN.fix_bn, group=group,
                                                  mesh=mesh)
            log.info("gt_gradient_intrinsic_only: optimizer updates disabled")
        else:
            train_step = S.make_train_step(lcfg, make_stage_schedules(cfg),
                                           fix_bn=cfg.TRAIN.fix_bn, group=group, mesh=mesh)
        eval_step = S.make_eval_step(lcfg, group=group, mesh=mesh)
        num_fg = cfg.DATASET.num_class - 1

        def stream(seed: int, n: int):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            for _ in range(n):
                yield shard_batch(make_batch_device(gen, global_batch, args.canvas, num_fg),
                                  block, blocks)

        def to_device(batch):
            return {k: host_to_device(v, device) for k, v in batch.items()}

        if args.data == "synthetic":
            def train_loader(epoch):
                return prefetch(stream(cfg.TRAIN.seed + epoch, cfg.TRAIN.epoch_iters))

            def val_loader():
                return stream(cfg.TRAIN.seed + 10_000, 8)
        else:
            def train_loader(epoch):
                return prefetch(train_ds.batches(global_batch, shuffle=True,
                                                 seed=cfg.TRAIN.seed + epoch, rank=block,
                                                 world=blocks), transform=to_device)

            def val_loader():
                return prefetch(val_ds.batches(global_batch, shuffle=False, rank=block,
                                               world=blocks), transform=to_device)

        def visual_fn(state, epoch):
            from fovealseg_torch.utils.visuals import collect_deform_visuals, dump_batch_visuals

            if r != 0 and mesh is None:
                return
            # on the 2-D mesh every rank runs the sharded forward; rank 0 writes
            vis = collect_deform_visuals(state.model, next(iter(val_loader())),
                                         cfg.DATASET.num_class)
            if r != 0:
                return
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
