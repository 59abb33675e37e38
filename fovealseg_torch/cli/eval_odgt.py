"""Multi-scale ODGT evaluation of the port (counterpart of ``cli/eval_odgt.py``):
ADE20K (``fovealseg_torch/configs/ade20k.yaml``) and the other ODGT
families.

  python -m fovealseg_torch.cli.eval_odgt --cfg fovealseg_torch/configs/ade20k.yaml \
      [--gaze R C] [--no-deform] [--num-samples N] [--object-info CSV] \
      [--torch-ckpt DIR --torch-epoch N] [--device cuda] [KEY VALUE ...]

Each record of ``DATASET.list_val`` (``data/odgt.py::ValDataset``: one image
resized to every pyramid level, its label at the original size) runs
``DeformSegmentation.infer`` at each level with the label for the round
trips, and the full-resolution score maps are averaged over the levels on
the device in the JAX CLI's order (``s / n``, then ``+ s / n`` for each
later level). Argmax, accuracy and per-class IoU run on the device too
(``core/metrics.py``, the family's ignore index for the IoU: 0 for
Cityscapes); only the scalars and the class histograms reach the host. The
warped-domain ("deformed") metrics take the last level's task-space
prediction against the label sampled through its ``grid_y`` ('nearest'),
and ``VAL.y_sampled_reverse`` adds the label round trip's IoU and accuracy.

``--no-deform`` evaluates a plain ``SegmentationModule`` instead: its
softmax probabilities resized to the label's size, averaged the same way,
full-resolution metrics only.

The records carry no gaze point: ``--gaze r c`` (default 0.5 0.5, the
image centre) sets it for every record. Weights, in the JAX CLI's order:
``--torch-ckpt``, then ``MODEL.weights_*`` (a missing file raises), then
(foveated only) the port's training checkpoint in ``DIR`` at
``TRAIN.start_epoch``, else random weights from ``TRAIN.seed`` with a
warning. ``VAL.visualize`` writes the side-by-side PNGs under
``DIR/result`` and the label-distribution scalars; ``VAL.report_per_img_iou``
writes ``DIR/image_IoUs_list.csv``. ``VAL.ensemble`` and
``VAL.approx_pred_Fxlr_by_ensemble`` raise, as in the JAX CLI.

:func:`evaluate_record` is one record's work, for callers that check it
in-process; :func:`main` takes ``on_record`` and ``timing`` for the same.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch


def val_dataset(cfg):
    """The ``ValDataset`` of ``DATASET.list_val`` with the config's pyramid."""
    from fovealseg_torch.data.odgt import ValDataset

    sizes = cfg.DATASET.imgSizes
    return ValDataset(
        root_dataset=cfg.DATASET.root_dataset,
        odgt=cfg.DATASET.list_val,
        num_class=cfg.DATASET.num_class,
        class_mapping=cfg.DATASET.class_mapping,
        list_train=cfg.DATASET.list_train,
        imgSizes=tuple(sizes) if isinstance(sizes, (list, tuple)) else (sizes,),
        imgMaxSize=cfg.DATASET.imgMaxSize,
        padding_constant=cfg.DATASET.padding_constant,
        segm_downsampling_rate=cfg.DATASET.segm_downsampling_rate,
        binary_class=cfg.DATASET.binary_class,
        val_central_crop=cfg.DATASET.val_central_crop,
        val_central_crop_shape=tuple(cfg.DATASET.val_central_crop_shape),
        expand_prediection_rate=cfg.VAL.expand_prediection_rate,
    )


def ignore_index_of(family: str, cfg):
    """The IoU's ignore index: 0 for Cityscapes, else ``DATASET.ignore_index``
    (None when it is -2)."""
    if family == "cityscapes":
        return 0
    return cfg.DATASET.ignore_index if cfg.DATASET.ignore_index != -2 else None


def build_module(cfg, no_deform: bool, device):
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.segmentation_module import SegmentationModule

    dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bfloat16" else torch.float32
    dc = DeformConfig.from_cfg(cfg)
    if no_deform:
        return SegmentationModule(dc, dtype=dtype, device=device)
    return DeformSegmentation(dc, dtype=dtype, device=device)


@torch.no_grad()
def evaluate_record(module, rec: dict, gaze, device, no_deform: bool = False,
                    rev_y: bool = False) -> dict:
    """One ``ValDataset`` record through every pyramid level. Returns device
    tensors: ``seg`` [H, W] int64 (-1 ignored), ``scores`` [1, H, W, C] f32
    (the mean over the levels), ``pred`` [H, W] int64 (its argmax); foveated
    also ``pred_deformed`` [th, tw] (the last level's task-space argmax) and
    ``y_sampled`` [th, tw] int64 (the label through that level's ``grid_y``),
    and with ``rev_y`` ``y_sampled_reverse`` [H, W] int64 (the label round
    trip of the last level). Each level's full-resolution output is freed
    before the next level runs."""
    from fovealseg_torch.core.warp import grid_sample

    seg = torch.from_numpy(np.asarray(rec["seg_label"][0], np.int64)).to(device)
    seg_hw = (seg.shape[0], seg.shape[1])
    y = seg[None]
    f = torch.tensor([list(gaze)], dtype=torch.float32, device=device)
    n = len(rec["img_data"])
    scores = last = None
    for x_np in rec["img_data"]:
        x = torch.from_numpy(np.ascontiguousarray(x_np, np.float32)).to(device)
        if no_deform:
            s = module.infer(x, seg_hw=seg_hw)
        else:
            out = module.infer(x, f, seg_hw=seg_hw, y=y, y_sampled_reverse=rev_y)
            s = out.pop("pred_sampled").to(torch.float32)
            last = {k: out[k] for k in ("pred", "grid_y", "y_sampled_reverse") if k in out}
            del out
        # in place, the same arithmetic as ``s / n`` then ``scores + s / n``
        s.div_(n)
        if scores is None:
            scores = s
        else:
            scores.add_(s)
        del s
    res = {"seg": seg, "scores": scores, "pred": torch.argmax(scores[0], dim=-1)}
    if not no_deform:
        res["pred_deformed"] = torch.argmax(last["pred"][0].to(torch.float32), dim=-1)
        y_s = grid_sample(y.to(torch.float32)[..., None], last["grid_y"], mode="nearest")
        res["y_sampled"] = y_s[0, ..., 0].to(torch.int64)
        if rev_y:
            res["y_sampled_reverse"] = last["y_sampled_reverse"][0].to(torch.int64)
    return res


def _class_fractions(labels: torch.Tensor, nc: int) -> torch.Tensor:
    """The class histogram of ``labels`` over [0, nc) normalised by its sum
    (``np.histogram(labels, nc, (0, nc - 1))`` for integer labels), f64."""
    lab = labels.reshape(-1)
    lab = torch.where((lab >= 0) & (lab < nc), lab, nc)
    h = torch.bincount(lab, minlength=nc + 1)[:nc].to(torch.float64)
    return h / torch.clamp(h.sum(), min=1.0)


class OdgtAccumulator:
    """The JAX CLI's sums over records, kept on the device: IoU
    histograms, accuracy sums (f64 sums of the per-record f32 values) and
    the label-distribution meters."""

    def __init__(self, nc: int, ignore_index, deform: bool, rev_y: bool):
        self.nc, self.ignore_index, self.deform, self.rev_y = nc, ignore_index, deform, rev_y
        self.sums: dict = {}
        self.per_img_rows: list = []
        self.n = 0

    def _add(self, key, value):
        self.sums[key] = value if key not in self.sums else self.sums[key] + value

    def add(self, res: dict, name: str | None = None):
        """``res``: :func:`evaluate_record`'s output. ``name`` (the image's
        file name) adds a per-image IoU row."""
        from fovealseg_torch.core import metrics as M

        nc, seg = self.nc, res["seg"]
        # the ignore index applies to the IoU only; accuracy counts label >= 0
        seg_iou = seg if self.ignore_index is None else torch.where(seg == self.ignore_index,
                                                                    -1, seg)
        pred = res["pred"]
        self._add("acc", M.accuracy(pred, seg)[0].to(torch.float64))
        i1, u1 = M.intersection_and_union(pred, seg_iou, nc)
        self._add("inter", i1)
        self._add("union", u1)
        if name is not None:
            img_iou = i1.to(torch.float64) / (u1.to(torch.float64) + 1e-10)
            img_iou = img_iou.cpu().numpy()
            self.per_img_rows.append((name, float(img_iou.mean()), img_iou.tolist()))
        if self.deform:
            y_s = res["y_sampled"]
            self._add("y_dist", _class_fractions(seg, nc))
            self._add("y_samp_dist", _class_fractions(y_s, nc))
            self._add("acc_def", M.accuracy(res["pred_deformed"], y_s)[0].to(torch.float64))
            i2, u2 = M.intersection_and_union(res["pred_deformed"], y_s, nc)
            self._add("inter_def", i2)
            self._add("union_def", u2)
        if self.rev_y:
            yr = res["y_sampled_reverse"]
            self._add("acc_rev", M.accuracy(yr, seg)[0].to(torch.float64))
            i3, u3 = M.intersection_and_union(yr, seg_iou, nc)
            self._add("inter_rev", i3)
            self._add("union_rev", u3)
        self.n += 1

    def host(self) -> dict:
        """The sums on the host (numpy)."""
        return {k: v.cpu().numpy() for k, v in self.sums.items()}

    def result(self, scales) -> dict:
        """The JAX CLI's result dict."""
        h, n = self.host(), max(self.n, 1)

        def miou(i, u):
            if i is None or u is None:  # no record evaluated
                return 0.0
            i, u = np.asarray(i, np.float64), np.asarray(u, np.float64)
            present = u > 0
            return float((i[present] / u[present]).mean()) if present.any() else 0.0

        result = {
            "mean_iou": miou(h.get("inter"), h.get("union")),
            "pixel_acc": float(h.get("acc", 0.0)) / n,
            "num_samples": self.n,
            "scales": list(scales),
        }
        if self.deform:
            result["mean_iou_deformed"] = miou(h.get("inter_def"), h.get("union_def"))
            result["pixel_acc_deformed"] = float(h.get("acc_def", 0.0)) / n
        if self.rev_y and "inter_rev" in h:
            result["y_reverse_iou"] = miou(h["inter_rev"], h["union_rev"])
            result["y_reverse_acc"] = float(h["acc_rev"]) / n
        return result


def _visualize(cfg, rec, res, idx) -> None:
    """The side-by-side (image | label | prediction) PNG under ``DIR/result``."""
    from PIL import Image

    from fovealseg_torch.utils.ade import color_encode

    nc = cfg.DATASET.num_class
    seg, pred = res["seg"].cpu().numpy(), res["pred"].cpu().numpy()
    img_u8 = np.clip(rec["img_ori"] * 255.0, 0, 255).astype(np.uint8)
    im_vis = np.concatenate((img_u8, color_encode(np.maximum(seg, 0), nc),
                             color_encode(pred, nc)), axis=1)
    dir_result = os.path.join(cfg.DIR, "result")
    os.makedirs(dir_result, exist_ok=True)
    name = str(rec.get("info", idx)).split("/")[-1].replace(".jpg", ".png")
    if not name.endswith(".png"):
        name += ".png"
    Image.fromarray(im_vis).save(os.path.join(dir_result, name))


def main(argv=None, on_record=None, timing: dict | None = None):
    """Run the evaluation and print its JSON line; returns the result dict.

    ``on_record(idx, rec, res)`` is called after each record's metrics are
    added, with the ``ValDataset`` record and :func:`evaluate_record`'s
    output. A ``timing`` dict receives the seconds of each record (its
    reading, inference and metrics, ended by a device synchronisation)."""
    parser = argparse.ArgumentParser(description="fovealseg multi-scale ODGT eval on a CUDA device")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--gpus", default="0", help="the card to run on (one)")
    parser.add_argument("--gaze", type=float, nargs=2, default=(0.5, 0.5),
                        help="normalized (row, col) gaze for the foveation")
    parser.add_argument("--no-deform", action="store_true",
                        help="evaluate a plain (non-foveated) SegmentationModule: softmax "
                             "probabilities per scale, averaged, full-res metrics only")
    parser.add_argument("--num-samples", type=int, default=-1)
    parser.add_argument("--object-info", default=None,
                        help="object150_info.csv-style class metadata (optional; generic "
                             "names are synthesized otherwise)")
    parser.add_argument("--torch-ckpt", default=None)
    parser.add_argument("--torch-epoch", default="last")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from fovealseg_torch.cli.eval import eval_device, load_weights
    from fovealseg_torch.configs import get_default_cfg
    from fovealseg_torch.data.odgt import warn_dead_options
    from fovealseg_torch.utils.ade import class_names

    device = eval_device(args)
    cfg = get_default_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("fovealseg.eval_odgt")
    warn_dead_options(cfg, log)
    if cfg.VAL.ensemble or cfg.VAL.approx_pred_Fxlr_by_ensemble:
        raise NotImplementedError(
            "VAL.ensemble / VAL.approx_pred_Fxlr_by_ensemble are not implemented (untested "
            "fixed-patch ensemble in the reference)")

    ds = val_dataset(cfg)
    n_samples = len(ds) if args.num_samples < 0 else min(args.num_samples, len(ds))
    log.info("ValDataset: %d records (%s family), scales %s", len(ds), ds.family, ds.imgSizes)
    nc = cfg.DATASET.num_class
    deform = not args.no_deform
    rev_y = bool(cfg.VAL.y_sampled_reverse) and deform
    module = build_module(cfg, args.no_deform, device)
    load_weights(module, cfg, args.torch_ckpt, args.torch_epoch, log,
                 kinds=("encoder", "decoder") if args.no_deform else None,
                 dir_checkpoint=not args.no_deform)

    acc = OdgtAccumulator(nc, ignore_index_of(ds.family, cfg), deform, rev_y)
    seconds = []
    for idx in range(n_samples):
        t0 = time.perf_counter()
        rec = ds[idx]
        res = evaluate_record(module, rec, args.gaze, device, args.no_deform, rev_y)
        name = (str(rec.get("info", idx)).split("/")[-1]
                if cfg.VAL.report_per_img_iou else None)
        acc.add(res, name)
        if cfg.VAL.visualize:
            _visualize(cfg, rec, res, idx)
        if on_record is not None:
            on_record(idx, rec, res)
        del res
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    result = acc.result(ds.imgSizes)
    if timing is not None:
        timing.update(seconds_per_record=seconds)

    h = acc.host()
    if cfg.VAL.visualize and acc.n > 0 and deform:
        # per-class deformed-vs-original label-distribution scalars
        from fovealseg_torch.utils.observe import SummaryWriter

        writer = SummaryWriter(os.path.join(cfg.DIR, "tensorboard"))
        y_dist, y_samp_dist = h["y_dist"] / acc.n, h["y_samp_dist"] / acc.n
        for c in range(nc):
            tag = f"Eval Deformed Label vs Label Original distribution Class {c}"
            writer.add_scalar(f"{tag}/Label Original distribution", float(y_dist[c]),
                              cfg.TRAIN.start_epoch)
            writer.add_scalar(f"{tag}/Deformed Label", float(y_samp_dist[c]),
                              cfg.TRAIN.start_epoch)
        writer.close()
    if cfg.VAL.report_per_img_iou and acc.per_img_rows:
        # worst first, as the reference writes it
        import csv

        rows = sorted(acc.per_img_rows, key=lambda r: r[1])
        os.makedirs(cfg.DIR, exist_ok=True)
        with open(os.path.join(cfg.DIR, "image_IoUs_list.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["idx", "image_name", "image_mIoU"]
                       + [f"img_iou_class_{c}" for c in range(nc)])
            for i, (name, miou_v, per_cls) in enumerate(rows):
                w.writerow([i, name, miou_v] + per_cls)
        log.info("per-image IoU table: %s", os.path.join(cfg.DIR, "image_IoUs_list.csv"))
    names = class_names(args.object_info, nc)
    if "inter" in h:
        i_np, u_np = np.asarray(h["inter"], np.float64), np.asarray(h["union"], np.float64)
        for c in range(nc):
            if u_np[c] > 0:
                log.info("class [%d] %s, IoU: %.4f", c, names[c], i_np[c] / u_np[c])
    log.info("multi-scale eval: %s", json.dumps(result))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
