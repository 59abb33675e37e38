"""Full-resolution evaluation CLI of the port (counterpart of ``cli/eval.py``).

Runs ``DeformSegmentation.infer`` (forward warp, segment, inverse warp with
hole fill) over an evaluation stream and reports full-resolution mean IoU,
pixel accuracy and per-class IoU, and when asked Dice, hd95, the trimap band
accuracies and the ``VAL.y_sampled_reverse`` IoU: the JAX CLI's result dict
and its printed JSON line. IoU and accuracy accumulate on the device; Dice,
hd95 and the trimap run per sample on the host.

Usage:
  python -m fovealseg_torch.cli.eval --cfg fovealseg_torch/configs/deform.yaml \
      [--data synthetic|<cook root> [--image-root DIR]] [--torch-ckpt DIR --torch-epoch N] \
      [--num-batches N] [--canvas 640] [--device cuda] [KEY VALUE ...]

The stream is the synthetic set (``--data synthetic``, the default), drawn
from ``default_rng(TRAIN.seed)``. The JAX CLI draws one batch to initialise
its model before its loop, so it evaluates draws 2..N+1; this CLI draws and
discards one batch, so that both evaluate the same frames. ``--data <cook
root>`` evaluates the first ``--num-batches`` batches of the cooked LVIS
``valid`` partition (``DATASET.dataset_marker_valid``, images from
``--image-root``) in order, as the JAX CLI does.

``TPU.quantize int8`` evaluates W8A8 serving, as the JAX CLI does: the
weights are quantized once after they load
(``models/layers.py::quantize_model``; on the card the convs run K6, K7 and
K8 of ``ops/quant.py``). ``TPU.conv_pack`` is a TPU layout of the same
convolution and changes nothing here.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch


class EvalAccumulator:
    """The eval metrics of the JAX CLI, fed one batch at a time with
    :meth:`add` (labels [B, H, W] on any device) and read with
    :meth:`result`. Intersection, union and accuracy stay on the labels'
    device; Dice, hd95 and the trimap run per sample on the host, and with
    ``VAL.trimap_visual_check`` the first sample's bands are dumped as
    ``.npy`` under ``DIR/trimap_visual_check``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_class = cfg.DATASET.num_class
        self.bg = self.num_class - 1
        self.inter = self.union = None
        self.acc_sum = None  # f64 sum of the per-batch f32 accuracies
        self.yrev_inter = self.yrev_union = None
        self.n = 0
        self.dices: list = []
        self.hd95s: list = []
        self.trimaps: dict = {}  # dilation width -> per-sample band accuracies

    def add(self, pred: torch.Tensor, gt: torch.Tensor, y_reverse: torch.Tensor | None = None):
        from fovealseg_torch.core import metrics as M

        cfg = self.cfg
        pred = pred.to(torch.int64)
        gt = gt.to(torch.int64)
        if y_reverse is not None:
            # the ids are truncated to integers, as the JAX CLI does
            i2, u2 = M.intersection_and_union(y_reverse.to(torch.int64), gt, self.num_class)
            self.yrev_inter = i2 if self.yrev_inter is None else self.yrev_inter + i2
            self.yrev_union = u2 if self.yrev_union is None else self.yrev_union + u2
        inter, union = M.intersection_and_union(pred, gt, self.num_class)
        self.inter = inter if self.inter is None else self.inter + inter
        self.union = union if self.union is None else self.union + union
        acc = M.accuracy(pred, gt)[0].to(torch.float64)
        self.acc_sum = acc if self.acc_sum is None else self.acc_sum + acc
        if cfg.VAL.dice or cfg.VAL.hd95 or cfg.VAL.trimap:
            self._host_metrics(pred.cpu().numpy(), gt.cpu().numpy())
        self.n += 1

    def _host_metrics(self, pred: np.ndarray, gt: np.ndarray) -> None:
        from fovealseg_torch.core import metrics as M

        cfg, bg = self.cfg, self.bg
        for b in range(pred.shape[0]):
            pred_fg = pred[b] != bg
            gt_fg = gt[b] != bg
            if cfg.VAL.dice:
                self.dices.append(M.binary_dice(pred_fg, gt_fg))
            if cfg.VAL.hd95 and gt_fg.any():
                h = M.hd95(pred_fg, gt_fg)
                if h == h:
                    self.hd95s.append(h)
            if not cfg.VAL.trimap:
                continue
            # one band per dilation width 2^i, i in 0..trimap_dia_factor
            for i_w in range(cfg.VAL.trimap_dia_factor + 1):
                w = 2 ** i_w
                t = M.trimap_accuracy(pred[b], gt[b], w)
                if t == t:
                    self.trimaps.setdefault(w, []).append(t)
                if cfg.VAL.trimap_visual_check and self.n == 0 and b == 0:
                    # the file names carry only the width: dump once
                    tdir = os.path.join(cfg.DIR, "trimap_visual_check")
                    os.makedirs(tdir, exist_ok=True)
                    band = M.trimap_band(gt[b], w)
                    np.save(os.path.join(tdir, f"seg_label_Edges_dil_{w}.npy"), band)
                    np.save(os.path.join(tdir, f"masked_label_dil_{w}.npy"), band * gt[b])
                    np.save(os.path.join(tdir, f"masked_pred_dil_{w}.npy"), band * pred[b])

    def result(self) -> dict:
        """The JAX CLI's result dict; writes ``DIR/trimap_last_count_{N}.csv``
        when the trimap is on."""
        cfg = self.cfg
        inter, union = self.inter.cpu().numpy(), self.union.cpu().numpy()
        iou = inter / np.maximum(union, 1e-10)
        present = union > 0
        result = {
            "mean_iou": float(iou[present].mean()),
            "pixel_acc": float(self.acc_sum.cpu()) / max(self.n, 1),
            "num_batches": self.n,
            "per_class_iou": {int(i): float(v) for i, v in enumerate(iou) if present[i]},
        }
        if self.dices:
            result["dice"] = float(np.mean(self.dices))
        if self.hd95s:
            result["hd95"] = float(np.mean(self.hd95s))
        if self.trimaps:
            import csv

            widths = sorted(self.trimaps)
            result["trimap_acc"] = {int(w): float(np.mean(self.trimaps[w])) for w in widths}
            count = len(self.trimaps[widths[0]])
            os.makedirs(cfg.DIR, exist_ok=True)
            with open(os.path.join(cfg.DIR, f"trimap_last_count_{count}.csv"), "w",
                      newline="") as fh:
                cw = csv.writer(fh)
                cw.writerow(["idx", "trim_acc", "trim_width"])
                for i_r, w in enumerate(widths):
                    cw.writerow([i_r, float(np.mean(self.trimaps[w])), w])
        if self.yrev_union is not None:
            yu = self.yrev_union.cpu().numpy()
            yiou = self.yrev_inter.cpu().numpy() / np.maximum(yu, 1e-10)
            result["y_reverse_iou"] = float(yiou[yu > 0].mean())
        return result


def accumulate(batches, cfg) -> dict:
    """The eval result of ``(pred_labels, gt, y_reverse or None)`` batches."""
    acc = EvalAccumulator(cfg)
    for pred, gt, y_reverse in batches:
        acc.add(pred, gt, y_reverse)
    return acc.result()


def refuse_unported(cfg) -> None:
    """Raise for every option this CLI does not run."""
    if cfg.VAL.ensemble or cfg.VAL.approx_pred_Fxlr_by_ensemble:
        raise NotImplementedError(
            "VAL.ensemble / VAL.approx_pred_Fxlr_by_ensemble are not implemented (an "
            "untested fixed-patch ensemble baseline of the reference, refused by the JAX CLI "
            "too); unset them")
    from fovealseg_torch.cli.infer import quantize_option

    quantize_option(cfg)  # "" or "int8", else raise


def load_weights(module, cfg, torch_ckpt, torch_epoch, log, kinds=None,
                 dir_checkpoint: bool = True) -> None:
    """Weights in the JAX CLI's order of precedence: ``--torch-ckpt``, then
    ``MODEL.weights_*`` (a named file that is missing raises), then, with
    ``dir_checkpoint``, the training checkpoint in ``DIR`` at
    ``TRAIN.start_epoch``, else random weights from ``TRAIN.seed`` with a
    warning. ``kinds`` names the networks ``module`` holds (default: all
    four file kinds)."""
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.train import checkpoint as ckpt

    kinds = tuple(ckpt.SUBMODULE_OF_FILE) if kinds is None else tuple(kinds)
    if torch_ckpt:
        ckpt.load_torch_weight_files(
            module, {k: os.path.join(torch_ckpt, f"{k}_epoch_{torch_epoch}.pth") for k in kinds})
        log.info("imported torch checkpoint from %s", torch_ckpt)
        return
    files = {"encoder": cfg.MODEL.weights_encoder, "decoder": cfg.MODEL.weights_decoder,
             "saliency": cfg.MODEL.weights_net_saliency,
             "compress": cfg.MODEL.weights_net_compress}
    files = {k: files[k] for k in kinds}
    if any(files.values()):
        ckpt.load_torch_weight_files(module, files)
        log.info("loaded MODEL.weights_* files: %s", {k: v for k, v in files.items() if v})
        return
    if dir_checkpoint and cfg.TRAIN.start_epoch > 0 and os.path.isdir(cfg.DIR):
        # the training checkpoint of that epoch in DIR (train/checkpoint.py)
        ckpt.load_torch_checkpoint(module, cfg.DIR, cfg.TRAIN.start_epoch, strict=True)
        log.info("loaded the training checkpoint of epoch %d from %s", cfg.TRAIN.start_epoch,
                 cfg.DIR)
        return
    init_weights(module, torch.Generator().manual_seed(cfg.TRAIN.seed))
    log.warning(
        "no weights loaded (no --torch-ckpt, no MODEL.weights_*, no resumable checkpoint): "
        "evaluating RANDOMLY INITIALIZED weights; metrics are only meaningful for smoke tests")


def eval_device(args) -> torch.device:
    """``--device``, on the card that ``--gpus`` names (one card)."""
    from fovealseg_torch import resolve_device
    from fovealseg_torch.cli.train import parse_devices

    device = resolve_device(args.device)
    if device.type == "cuda" and args.gpus:
        ids = parse_devices(args.gpus)
        if len(ids) != 1:
            raise ValueError(f"--gpus {args.gpus}: the evaluation runs on one card; name one")
        device = torch.device("cuda", ids[0])
    return device


def synthetic_stream(cfg, num_batches: int, canvas: int):
    """The JAX CLI's frames: one draw discarded, then ``num_batches``."""
    from fovealseg_torch.data.synthetic import make_batch

    rng = np.random.default_rng(cfg.TRAIN.seed)
    make_batch(rng, cfg.VAL.batch_size, canvas=canvas)
    for _ in range(num_batches):
        yield make_batch(rng, cfg.VAL.batch_size, canvas=canvas)


def cooked_stream(cfg, root: str, image_root, num_batches: int, canvas: int = 640):
    """The first ``num_batches`` batches of the cooked LVIS ``valid``
    partition (``DATASET.dataset_marker_valid``, cooked on a ``canvas``
    square), in order, as the JAX CLI reads them. A training id that does not
    fit ``DATASET.num_class`` raises."""
    from fovealseg_torch.data.loader import check_class_ids
    from fovealseg_torch.data.lvis import DatasetLVIS

    ds = DatasetLVIS(os.path.join(root, "valid"), image_root, canvas=canvas,
                     marker=cfg.DATASET.dataset_marker_valid)
    check_class_ids(ds.class_ids(), cfg.DATASET.num_class, f"--data {root} (lvis valid)")
    for i, b in enumerate(ds.batches(cfg.VAL.batch_size, shuffle=False)):
        if i >= num_batches:
            break
        yield b


def _emit_visuals(cfg, writer, vis_dir, bi, x_np, out, pred_cls, gt):
    """The eval image set of the first batches: TensorBoard images, the
    per-iteration PNG dumps, and on the first batch the side-by-side
    (image | gt | pred) dumps under ``DIR/result``."""
    from fovealseg_torch.utils.visuals import dump_train_visuals, rgb_img

    nc = cfg.DATASET.num_class
    sm = out["xs"][..., 0].float().cpu().numpy()
    x_warp = out["x_sampled"].float().cpu().numpy()
    pred_task = out["pred"].float().cpu().numpy()
    pred_full = out["pred_sampled"].float().cpu().numpy()
    for i in range(min(x_np.shape[0], 2)):
        k = bi * cfg.VAL.batch_size + i
        s = sm[i] / (sm[i].max() + 1e-12)
        writer.add_image(f"eval_{k}/Saliency Map", np.repeat(s[..., None], 3, -1), bi)
        writer.add_image(f"eval_{k}/Deformed Image", x_warp[i], bi)
        writer.add_image(f"eval_{k}/Deformed pred",
                         np.asarray(rgb_img(np.argmax(pred_task[i], -1), nc), np.float32) / 255.0,
                         bi)
        writer.add_image(f"eval_{k}/Interpolated Deformed Pred",
                         np.asarray(rgb_img(np.argmax(pred_full[i], -1), nc), np.float32) / 255.0,
                         bi)
        writer.add_image(f"eval_{k}/Label Original",
                         np.asarray(rgb_img(gt[i], nc), np.float32) / 255.0, bi)
        dump_train_visuals(vis_dir, f"iter{bi}_batch{i}", pred_logits=pred_full[i],
                           gt_hr=gt[i], saliency=sm[i], num_classes=nc)
        if bi == 0:
            from PIL import Image

            from fovealseg_torch.utils.ade import color_encode

            img_u8 = np.clip(x_np[i] * 255.0, 0, 255).astype(np.uint8)
            im_vis = np.concatenate((img_u8, color_encode(np.maximum(gt[i], 0), nc),
                                     color_encode(pred_cls[i], nc)), axis=1)
            rdir = os.path.join(cfg.DIR, "result")
            os.makedirs(rdir, exist_ok=True)
            Image.fromarray(im_vis).save(os.path.join(rdir, f"batch{bi}_sample{i}.png"))


def main(argv=None, timing: dict | None = None, on_batch=None):
    """Run the eval and print its JSON line; returns the result dict.

    For callers that check or time the run in-process: a ``timing`` dict
    receives the throughput (frames and seconds on the wall clock after the
    first batch, with the synthetic data generation inside the window), and
    ``on_batch(out, pred, gt, acc)`` is called after each batch's metrics
    are added, with ``infer``'s outputs, the labels and the accumulator."""
    parser = argparse.ArgumentParser(description="fovealseg full-res eval on a CUDA device")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--gpus", default="0", help="the card to run on (one)")
    parser.add_argument("--data", default="synthetic")
    parser.add_argument("--image-root", default=None)
    parser.add_argument("--torch-ckpt", default=None, help="dir with {kind}_epoch_{N}.pth files")
    parser.add_argument("--torch-epoch", default="last")
    parser.add_argument("--num-batches", type=int, default=16)
    parser.add_argument("--canvas", type=int, default=640,
                        help="the synthetic canvas, or the cooked set's (640, as the JAX CLI's "
                             "reader assumes)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from fovealseg_torch.configs import audit_dead_keys, get_default_cfg
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation

    device = eval_device(args)
    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("fovealseg.eval")
    audit_dead_keys(cfg, log)
    refuse_unported(cfg)

    dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bfloat16" else torch.float32
    module = DeformSegmentation(DeformConfig.from_cfg(cfg), dtype=dtype, device=device)
    load_weights(module, cfg, args.torch_ckpt, args.torch_epoch, log)
    if cfg.TPU.quantize:
        from fovealseg_torch.models.layers import quantize_model

        log.info("TPU.quantize int8: %d convs serve W8A8", quantize_model(module))
    bg = cfg.DATASET.num_class - 1

    rev_y = bool(cfg.VAL.y_sampled_reverse)
    rev_x = bool(cfg.VAL.x_sampled_reverse)
    # the metrics need only argmax(pred_sampled): without visualisation the
    # argmax-only inverse warp carries one int32 channel, exactly
    visualize = bool(cfg.VAL.visualize or cfg.TRAIN.train_eval_visualise)
    argmax_only = not visualize
    writer = vis_dir = None
    if visualize:
        from fovealseg_torch.utils.observe import SummaryWriter

        os.makedirs(cfg.DIR, exist_ok=True)
        writer = SummaryWriter(os.path.join(cfg.DIR, "tensorboard"))
        vis_dir = os.path.join(cfg.DIR, f"valid_visual_epoch{cfg.TRAIN.start_epoch}")
    # the reference's exact 'tri': a host Delaunay plan per sample and the
    # blend on the device, in place of the splat fill of infer()
    tri_exact = (cfg.MODEL.rev_deform_interp == "tri" and cfg.MODEL.uniform_sample == ""
                 and bool(cfg.TPU.tri_exact))
    if tri_exact:
        from fovealseg_torch.native.interp2d import unwarp_prediction_tri_device

        log.info("tri_exact: Delaunay-barycentric hole fill active "
                 "(TPU.tri_exact=False for the splat fill)")

    acc = EvalAccumulator(cfg)
    t0, frames = None, 0
    if args.data == "synthetic":
        stream = synthetic_stream(cfg, args.num_batches, args.canvas)
    else:
        stream = cooked_stream(cfg, args.data, args.image_root, args.num_batches, args.canvas)
    for batch in stream:
        x = torch.from_numpy(batch["img_data"]).to(device)
        f = torch.from_numpy(batch["focus_point"]).to(device)
        y = batch["seg_label"]
        cls = batch["cls_label"].reshape(-1)
        gt_np = (y * cls[:, None, None] + (1 - y) * bg).astype(np.int64)
        gt = torch.from_numpy(gt_np).to(device)
        out = module.infer(x, f, y=gt, y_sampled_reverse=rev_y, x_sampled_reverse=rev_x,
                           argmax_labels=argmax_only)
        if tri_exact:
            out["pred_sampled"] = unwarp_prediction_tri_device(
                out["pred"], out["grid_inv"], ~out["unfilled_mask"])
            out.pop("pred_label", None)  # argmax of the exact fill instead
        if "pred_label" in out:
            pred = out["pred_label"]
        else:
            pred = torch.argmax(out["pred_sampled"], dim=-1)
        if visualize and acc.n < 4:
            _emit_visuals(cfg, writer, vis_dir, acc.n, batch["img_data"], out,
                          pred.cpu().numpy(), gt_np)
        acc.add(pred, gt, out["y_sampled_reverse"] if rev_y else None)
        if on_batch is not None:
            on_batch(out, pred, gt, acc)
        if t0 is None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        else:
            frames += x.shape[0]
    result = acc.result()  # reads the device sums: the window ends here
    seconds = time.perf_counter() - t0 if t0 is not None else 0.0
    if timing is not None:
        timing.update(frames=frames, seconds=seconds,
                      note="wall clock after the first batch; making or reading the data "
                           "and the host metrics inside the window")
    if writer is not None:
        writer.close()
    log.info("eval: mean_iou=%.4f acc=%.4f", result["mean_iou"], result["pixel_acc"])
    print(json.dumps({k: v for k, v in result.items() if k != "per_class_iou"}))
    return result


if __name__ == "__main__":
    main()
