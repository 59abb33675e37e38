"""Metrics (counterpart of ``fovealseg_tpu/core/metrics.py``).

The tensor metrics run on the tensor's device: the warped-domain
pixel-accuracy family (logits [B, H, W, C], labels [B, H, W]; class
``bg_class`` = 50 is background), full-resolution ``accuracy``,
``intersection_and_union`` and ``confusion_matrix``. The boundary metrics
(``trimap_*``, ``binary_dice``, ``hd95``) are host-side numpy, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch


def _preds(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num.to(torch.float32) / (den.to(torch.float32) + 1e-10)


def pixel_acc(logits: torch.Tensor, labels: torch.Tensor, bg_class: int = 50) -> torch.Tensor:
    """Per-sample fg-class accuracy over the fg union, averaged."""
    preds = _preds(logits)
    valid = labels < bg_class
    valid1 = preds < bg_class
    inter = torch.sum(valid & (preds == labels), dim=(1, 2))
    union = torch.sum(valid | valid1, dim=(1, 2))
    return torch.mean(_ratio(inter, union))


def fg_bin_pixel_acc(logits: torch.Tensor, labels: torch.Tensor,
                     bg_class: int = 50) -> torch.Tensor:
    """Binary (fg-vs-bg) IoU-style accuracy."""
    preds = _preds(logits)
    valid = labels < bg_class
    valid1 = preds < bg_class
    inter = torch.sum(valid & valid1, dim=(1, 2))
    union = torch.sum(valid | valid1, dim=(1, 2))
    return torch.mean(_ratio(inter, union))


def fbg_cls_pixel_acc(logits: torch.Tensor, labels: torch.Tensor,
                      bg_class: int = 50) -> torch.Tensor:
    """Class-correct accuracy averaged 50/50 over the fg and bg unions."""
    preds = _preds(logits)
    eq = preds == labels
    v_fg, v1_fg = labels < bg_class, preds < bg_class
    v_bg, v1_bg = labels == bg_class, preds == bg_class
    acc_fg = _ratio(torch.sum(v_fg & eq, dim=(1, 2)), torch.sum(v_fg | v1_fg, dim=(1, 2)))
    acc_bg = _ratio(torch.sum(v_bg & eq, dim=(1, 2)), torch.sum(v_bg | v1_bg, dim=(1, 2)))
    return torch.mean(0.5 * acc_fg + 0.5 * acc_bg)


def fbg_bin_pixel_acc(logits: torch.Tensor, labels: torch.Tensor,
                      bg_class: int = 50) -> torch.Tensor:
    """Binary accuracy averaged 50/50 over the fg and bg unions."""
    preds = _preds(logits)
    v_fg, v1_fg = labels < bg_class, preds < bg_class
    v_bg, v1_bg = labels == bg_class, preds == bg_class
    acc_fg = _ratio(torch.sum(v_fg & v1_fg, dim=(1, 2)), torch.sum(v_fg | v1_fg, dim=(1, 2)))
    acc_bg = _ratio(torch.sum(v_bg & v1_bg, dim=(1, 2)), torch.sum(v_bg | v1_bg, dim=(1, 2)))
    return torch.mean(0.5 * acc_fg + 0.5 * acc_bg)


def accuracy(preds: torch.Tensor, label: torch.Tensor):
    """(acc, num_valid) with valid = label >= 0; acc in float32."""
    valid = label >= 0
    acc_sum = torch.sum(valid & (preds == label))
    valid_sum = torch.sum(valid)
    return _ratio(acc_sum, valid_sum), valid_sum


def intersection_and_union(preds: torch.Tensor, label: torch.Tensor, num_class: int):
    """Per-class (intersection, union) int64 histograms. Pixels with
    label < 0 are ignored (the prediction is shifted out of range there); a
    negative prediction on a labelled pixel counts as class 0, as
    ``jnp.bincount`` clips it (the label round trip carries -1 ids)."""
    preds = torch.where(label >= 0, preds, num_class).to(torch.int64)
    label = torch.where(label >= 0, label, num_class).to(torch.int64)
    inter = torch.where(preds == label, preds, num_class)

    def hist(x):
        return torch.bincount(torch.clamp(x.reshape(-1), min=0),
                              minlength=num_class + 1)[:num_class]

    area_inter = hist(inter)
    union = hist(preds) + hist(label) - area_inter
    return area_inter, union


def confusion_matrix(preds: torch.Tensor, label: torch.Tensor, num_class: int) -> torch.Tensor:
    """[C, C] confusion counts over valid (0 <= label < C) pixels."""
    valid = (label >= 0) & (label < num_class)
    idx = torch.where(valid, label.to(torch.int64) * num_class + preds.to(torch.int64),
                      num_class * num_class)
    flat = torch.bincount(idx.reshape(-1), minlength=num_class * num_class + 1)
    return flat[: num_class * num_class].reshape(num_class, num_class)


def trimap_band(label: np.ndarray, width: int = 5) -> np.ndarray:
    """Pixels within ``width`` (4-neighbour dilations) of a class boundary:
    the VAL.trimap evaluation region."""
    lab = np.asarray(label)
    pad = np.pad(lab, 1, mode="edge")
    boundary = (
        (pad[1:-1, 1:-1] != pad[:-2, 1:-1])
        | (pad[1:-1, 1:-1] != pad[2:, 1:-1])
        | (pad[1:-1, 1:-1] != pad[1:-1, :-2])
        | (pad[1:-1, 1:-1] != pad[1:-1, 2:])
    )
    band = boundary.copy()
    for _ in range(width):
        p = np.pad(band, 1, mode="constant")
        band = p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
    return band


def trimap_accuracy(preds: np.ndarray, label: np.ndarray, width: int = 5) -> float:
    """Pixel accuracy restricted to the boundary band (NaN for no band)."""
    band = trimap_band(label, width)
    if band.sum() == 0:
        return float("nan")
    return float((preds[band] == label[band]).mean())


def binary_dice(preds: np.ndarray, label: np.ndarray) -> float:
    """Binary Dice coefficient (VAL.dice)."""
    inter = np.sum((preds > 0) & (label > 0))
    s = np.sum(preds > 0) + np.sum(label > 0)
    return float(2.0 * inter / (s + 1e-10))


def _boundary(mask: np.ndarray) -> np.ndarray:
    """4-neighbourhood boundary pixels of a binary mask."""
    m = mask.astype(bool)
    pad = np.pad(m, 1, mode="constant")
    eroded = pad[1:-1, 1:-1] & pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    return m & ~eroded


def hd95(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """95th-percentile symmetric surface distance, from the Euclidean distance
    transform of each border's complement read at the other border (O(HW)
    memory). NaN when either mask has no border."""
    from scipy.ndimage import distance_transform_edt

    pb = _boundary(pred_mask)
    gb = _boundary(gt_mask)
    if not pb.any() or not gb.any():
        return float("nan")
    d_pg = distance_transform_edt(~gb)[pb]
    d_gp = distance_transform_edt(~pb)[gb]
    return float(np.percentile(np.hstack([d_pg, d_gp]), 95))
