"""Serving CLI of the port: gaze-conditioned full-res segmentation of frames
(counterpart of ``cli/infer.py``).

Streams a folder of images (or synthetic frames) with gaze points through
``DeformSegmentation.infer(argmax_labels=True)`` and writes full-resolution
class-id masks (.npy, and .png previews with the HSV palette when --png).
Batches are staged to the card from pinned memory with non-blocking copies,
and each batch's masks are drained one batch behind, so the host prepares
and enqueues batch k+1 while the card computes batch k. Prints a one-line
JSON throughput summary.

``--mesh N`` (the JAX CLI's batch-split serving) runs N rank processes
(``parallel/launch.py``; one per card over NCCL, ``--device cpu`` over gloo,
``--gpus`` names the cards, ``--backend gloo`` lets ranks share one): each
rank serves its contiguous block of every micro-batch, and rank 0 gathers
the labels, writes the outputs and prints the summary. ``--batch`` and the
micro-batch must divide by N. A ``_nonsyn`` saliency net (batch statistics
at serving) takes them over the whole micro-batch, all ranks together, as
the JAX package's sharded serve does.

``--spatial N`` (N > 1, the JAX CLI's single-frame latency mode) runs N rank
processes the same way, each holding the whole frame batch: the warped
image's rows are split over them for the encoder and the decoder
(``parallel/spatial.py``; HRNetV2, SegFormer-B5 or DeepLabV3-R101 with C1),
and every rank runs the saliency net, the warp and the inverse warp whole;
rank 0 writes the masks and prints the summary, with the trunk's exchanges.
``--spatial`` with ``--mesh`` exits before any rank starts, as in the JAX
CLI.

``TPU.quantize int8`` serves W8A8, as the JAX CLI does: the weights of the
convs the JAX package builds as ``TorchConv`` with at least 128 input and
output channels are quantized once after they load
(``models/layers.py::quantize_model``), and each such conv quantizes its
input per call with one scale for the whole micro-batch, so the labels
depend on how ``--microbatch`` splits a batch. On the card each conv runs
K6, K7 and K8 (``ops/quant.py``); on the CPU their plain versions.
``TPU.quantize`` with ``--mesh`` or ``--spatial`` exits before any rank
starts (the scale would need one max over the ranks per conv).
``TPU.conv_pack`` is a TPU layout of the same convolution and changes
nothing here.

Usage:
  python -m fovealseg_torch.cli.infer --cfg fovealseg_torch/configs/deform.yaml \
      [--images DIR --gaze gaze.json | --num-batches N] [--out DIR] [--device cuda] \
      [--mesh N | --spatial N] [--gpus 0-3] [--backend nccl|gloo] [TPU.quantize int8]
  gaze.json: {"<image filename>": [fy, fx], ...} in [0,1]^2 (default center).
"""

from __future__ import annotations

import argparse
import colorsys
import json
import os
import time

import numpy as np
import torch


def _iter_image_batches(image_dir, gaze_map, canvas, batch):
    """Yield (names, imgs [B,H,W,3] f32, gaze [B,2] f32) from a folder,
    resizing each frame to the square canvas; the last batch is padded to
    ``batch`` frames and ``names`` lists only the real ones."""
    from PIL import Image

    names = sorted(n for n in os.listdir(image_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    for i in range(0, len(names), batch):
        chunk = names[i : i + batch]
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        imgs, gazes = [], []
        for n in padded:
            im = Image.open(os.path.join(image_dir, n)).convert("RGB").resize((canvas, canvas))
            imgs.append(np.asarray(im, np.float32) / 255.0)
            gazes.append(np.asarray(gaze_map.get(n, (0.5, 0.5)), np.float32))
        yield chunk, np.stack(imgs), np.stack(gazes)


def _microbatches(batches, micro):
    """Split each (names, imgs, gazes) batch into chunks of ``micro`` frames."""
    for names, imgs, gazes in batches:
        for j in range(0, len(imgs), micro):
            yield names[j : j + micro], imgs[j : j + micro], gazes[j : j + micro]


def synthetic_batches(num_batches, canvas, batch, seed=304):
    rng = np.random.default_rng(seed)
    for i in range(num_batches):
        names = [f"synthetic_{i}_{j}" for j in range(batch)]
        yield (names, rng.uniform(0, 1, (batch, canvas, canvas, 3)).astype(np.float32),
               rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32))


def _palette(num_classes: int) -> np.ndarray:
    """HSV wheel class palette; the last class (background) is black."""
    colors = []
    for i in range(num_classes):
        r, g, b = colorsys.hsv_to_rgb(i / num_classes, 1.0, 1.0)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    colors[-1] = (0, 0, 0)
    return np.asarray(colors, np.uint8)


def _stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def serve(module, batches, device, on_masks=None, group=None):
    """Run ``batches`` through ``module.infer(argmax_labels=True)``.

    Masks are drained one batch behind (``on_masks(names, uint8 [B,H,W])``).
    The first batch pays the warm-up and is left out of the throughput
    window. With a process ``group`` each rank serves its contiguous block of
    every batch and rank 0 gathers the masks (``on_masks`` runs there).
    Returns (frames in the window, seconds)."""
    from fovealseg_torch.parallel.mesh import shard_batch
    from fovealseg_torch.parallel.multihost import rank_and_world

    rank, world = rank_and_world(group) if group is not None else (0, 1)
    n_frames, pending, t0 = 0, None, None
    for names, imgs, gazes in batches:
        if group is not None:
            blk = shard_batch({"x": imgs, "f": gazes}, rank, world)
            imgs, gazes = blk["x"], blk["f"]
        label = module.infer(_stage(imgs, device), _stage(gazes, device),
                             argmax_labels=True)["pred_label"]
        timed = t0 is not None
        if t0 is None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        if pending is not None:
            n_frames += _drain(pending, on_masks, group)
        pending = (names, label, timed)
    if pending is not None:
        n_frames += _drain(pending, on_masks, group)
    return n_frames, max(time.perf_counter() - (t0 or time.perf_counter()), 1e-9)


def _drain(pending, on_masks, group=None) -> int:
    names, label, timed = pending
    masks = label.to(torch.uint8)
    if group is not None:
        from fovealseg_torch.parallel.mesh import all_gather_tensors

        masks = torch.cat(all_gather_tensors(masks, group))
    masks = masks.cpu().numpy()  # waits for this batch only
    if on_masks is not None:
        on_masks(names, masks)
    return len(names) if timed else 0


def _writer(out_dir, png):
    os.makedirs(out_dir, exist_ok=True)

    def write(names, masks):
        for n, m in zip(names, masks):
            stem = os.path.splitext(os.path.basename(n))[0]
            np.save(os.path.join(out_dir, stem + ".mask.npy"), m)
            if png:
                from PIL import Image

                # palette sized by the mask's own classes, as cli/infer.py does
                Image.fromarray(_palette(int(m.max()) + 1)[m]).save(
                    os.path.join(out_dir, stem + ".mask.png"))

    return write


def build_model(cfg, device, torch_ckpt=None, torch_epoch="last"):
    """DeformSegmentation from a merged config, seeded from TRAIN.seed or
    loaded from a 4-file checkpoint."""
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bfloat16" else torch.float32
    module = DeformSegmentation(DeformConfig.from_cfg(cfg), dtype=dtype, device=device)
    if torch_ckpt:
        from fovealseg_torch.train.checkpoint import load_torch_checkpoint

        load_torch_checkpoint(module, torch_ckpt, torch_epoch)
    else:
        init_weights(module, torch.Generator().manual_seed(cfg.TRAIN.seed))
    return module


def quantize_option(cfg) -> bool:
    """``TPU.quantize`` as the JAX CLIs read it: "" (float serving) or
    "int8" (W8A8); any other value raises."""
    if cfg.TPU.quantize not in ("", "int8"):
        raise ValueError(f"unknown TPU.quantize {cfg.TPU.quantize!r}: \"\" or \"int8\"")
    return cfg.TPU.quantize == "int8"


def _parse(argv):
    parser = argparse.ArgumentParser(description="fovealseg serving on CUDA devices")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--images", default=None, help="folder of frames")
    parser.add_argument("--gaze", default=None, help="json: name -> [fy, fx]")
    parser.add_argument("--out", default=None, help="write masks here")
    parser.add_argument("--png", action="store_true", help="also write palette previews")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--microbatch", type=int, default=0,
                        help="split each batch into chunks of this size (0 = min(batch, 8); "
                             "--microbatch equal to --batch runs whole batches)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="split each batch over N rank processes (0 = one process)")
    parser.add_argument("--spatial", type=int, default=0,
                        help="split each frame's encoder and decoder rows over N rank processes "
                             "(N > 1; single-frame latency, use with --batch 1; exclusive with "
                             "--mesh)")
    parser.add_argument("--gpus", default=None,
                        help="the ranks' cards with --mesh or --spatial, reference grammar "
                             "(default 0..N-1)")
    parser.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                        help="the ranks' backend (default: NCCL on cards, gloo on the CPU)")
    parser.add_argument("--canvas", type=int, default=640)
    parser.add_argument("--num-batches", type=int, default=4,
                        help="synthetic batches when --images is absent")
    parser.add_argument("--torch-ckpt", default=None,
                        help="directory of {saliency,compress,encoder,decoder}_epoch_N.pth")
    parser.add_argument("--torch-epoch", default="last")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    micro = args.microbatch or min(args.batch, 8)
    if micro > args.batch or args.batch % micro:
        micro = args.batch
    if args.mesh:
        if args.batch % args.mesh:
            raise SystemExit("--batch must be divisible by --mesh")
        if micro % args.mesh:
            raise SystemExit(f"the micro-batch ({micro}) must be divisible by --mesh")
    if args.spatial > 1 and args.mesh:
        raise SystemExit("--spatial and --mesh are exclusive")
    if quantize_option(cfg) and (args.mesh or args.spatial > 1):
        raise SystemExit("TPU.quantize int8 serves in one process: its activation scale spans "
                         "the micro-batch, which --mesh and --spatial split over ranks")
    return args, cfg, micro


def main(argv=None):
    """Serve and return the summary, with the kernel launches of this serve
    (``launches``); with ``--mesh N``, each rank's summary in rank order."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args, _, _ = _parse(argv)
    ranks = args.mesh or (args.spatial if args.spatial > 1 else 0)
    if ranks:
        from fovealseg_torch.parallel.launch import run_workers

        if args.device == "cpu":
            device = "cpu"
        else:
            from fovealseg_torch.cli.train import parse_devices

            device = parse_devices(args.gpus) if args.gpus else "cuda"
        return run_workers(ranks, _rank_main, argv, device=device, backend=args.backend,
                           echo=True, threads=1 if device == "cpu" else None)
    return _serve(argv, None)


def _rank_main(rank, argv):
    return _serve(argv, rank)


def _serve(argv, rank):
    from fovealseg_torch import resolve_device
    from fovealseg_torch.models.layers import quantize_model, set_batch_stats_group
    from fovealseg_torch.ops import gather, jfa, quant
    from fovealseg_torch.parallel import spatial

    args, cfg, micro = _parse(argv)
    kernels = {"jfa_class": jfa.nearest_class, "row_gather": gather.row_gather,
               "absmax_scale": quant.absmax_scale, "quantize_act": quant.quantize_act,
               "int8_conv2d": quant.int8_conv2d}
    before = {name: fn.launches for name, fn in kernels.items()}
    exchanges = spatial.exchanges
    if rank is None:
        device, group, main_rank = resolve_device(args.device), None, True
    else:
        import torch.distributed as dist

        device, group, main_rank = rank.device, dist.group.WORLD, rank.rank == 0
    module = build_model(cfg, device, args.torch_ckpt, args.torch_epoch)
    quantized = quantize_model(module) if quantize_option(cfg) else 0
    if group is not None and args.spatial > 1:
        module.set_spatial(group)
        group = None  # every rank serves the whole batch
    elif group is not None:
        set_batch_stats_group(module, group)  # the _nonsyn nets: the whole micro-batch's
    if args.images:
        gaze_map = {}
        if args.gaze:
            with open(args.gaze) as fh:
                gaze_map = json.load(fh)
        batches = _iter_image_batches(args.images, gaze_map, args.canvas, args.batch)
    else:
        batches = synthetic_batches(args.num_batches, args.canvas, args.batch)
    if micro != args.batch:
        batches = _microbatches(batches, micro)
    on_masks = _writer(args.out, args.png) if args.out and main_rank else None

    n_frames, dt = serve(module, batches, device, on_masks, group)
    summary = {
        "frames": n_frames,
        "seconds": dt,
        "fps": n_frames / dt,
        "canvas": args.canvas,
        "batch": args.batch,
        "microbatch": micro,
        "mesh": args.mesh,
        "spatial": args.spatial,
        "task": list(module.config.task_hw_infer),
        "dtype": str(module.dtype).replace("torch.", ""),
        "quantize": cfg.TPU.quantize,
        "quantized_convs": quantized,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "note": "wall clock after the first batch, host IO included",
    }
    if main_rank:
        print(json.dumps(summary), flush=True)
    summary["launches"] = {name: fn.launches - before[name] for name, fn in kernels.items()}
    summary["exchanges"] = spatial.exchanges - exchanges
    return summary


if __name__ == "__main__":
    main()
