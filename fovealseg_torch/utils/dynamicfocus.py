"""DynamicFocus auxiliary utilities (counterpart of
``fovealseg_tpu/utils/dynamicfocus.py``, a numpy copy): the gaze-centred crop
window, per-class confusion metrics, the distribution CDFs and image
normalisers, early stopping and timers. Host helpers, off every hot path;
the metrics the CLIs use are in ``fovealseg_torch/core/metrics.py``.
"""

from __future__ import annotations

import random
import time
from typing import Callable

import numpy as np


# ---------------------------------------------------------------------------
# gaze-centered crop window (DynamicFocus's croper)
# ---------------------------------------------------------------------------

def get_idxs_crop4(idx_h: int, idx_w: int, h_canvas: int, w_canvas: int,
                   h_crop: int, w_crop: int, rng: random.Random | None = None):
    """(left, right, up, bottom) of an h_crop x w_crop window centered on the
    gaze, clamped to the canvas; even crops randomly round the center."""
    if h_crop >= h_canvas or w_crop >= w_canvas:
        return 0, w_canvas, 0, h_canvas
    r = rng or random
    idx_h = min(max(0, idx_h), h_canvas - 1)
    idx_w = min(max(0, idx_w), w_canvas - 1)
    if h_crop % 2 == 0:
        idx_h = idx_h + int(round(r.random()))
    if w_crop % 2 == 0:
        idx_w = idx_w + int(round(r.random()))
    up = idx_h - h_crop // 2
    bottom = idx_h + h_crop // 2 + h_crop % 2
    left = idx_w - w_crop // 2
    right = idx_w + w_crop // 2 + w_crop % 2
    if up < 0:
        up, bottom = 0, h_crop
    if bottom > h_canvas:
        bottom, up = h_canvas, h_canvas - h_crop
    if left < 0:
        left, right = 0, w_crop
    if right > w_canvas:
        right, left = w_canvas, w_canvas - w_crop
    return left, right, up, bottom


# ---------------------------------------------------------------------------
# per-class confusion metrics (nn_A3_metrics.py:8-62)
# ---------------------------------------------------------------------------

def calc_confusion_matrix(preds: np.ndarray, targets: np.ndarray, num_classes: int) -> np.ndarray:
    """[C, 4] of per-class (TP, FP, FN, TN)."""
    out = np.zeros((num_classes, 4))
    for cls in range(num_classes):
        p = preds == cls
        t = targets == cls
        out[cls] = [(p & t).sum(), (p & ~t).sum(), (~p & t).sum(), (~p & ~t).sum()]
    return out


def calc_metrics(cm: np.ndarray, eps: float = 1e-7):
    """(iou, f1, accuracy, precision, recall) per class from [C,4] counts."""
    tp, fp, fn, tn = cm[:, 0], cm[:, 1], cm[:, 2], cm[:, 3]
    iou = tp / (tp + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    accuracy = (tp + tn) / (tp + tn + fp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return iou, f1, accuracy, precision, recall


def evaluate_segmentation(pred: np.ndarray, target: np.ndarray, threshold: float = 0.5,
                          eps: float = 1e-7):
    """Per-sample binary (iou, f1, acc, precision, recall) lists
    (nn_A3_metrics.py:85-124). pred/target: [B, ...]."""
    b = pred.shape[0]
    p = (pred.reshape(b, -1) >= threshold)
    t = (target.reshape(b, -1) >= threshold)
    tp = (p & t).sum(1).astype(float)
    tn = (~p & ~t).sum(1).astype(float)
    fp = (p & ~t).sum(1).astype(float)
    fn = (~p & t).sum(1).astype(float)
    iou = tp / (tp + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    accuracy = (tp + tn) / (tp + tn + fp + fn + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return iou.tolist(), f1.tolist(), accuracy.tolist(), precision.tolist(), recall.tolist()


def evaluate_classification(scores: np.ndarray, target: np.ndarray, class_num: int):
    """Per-class one-vs-rest (f1, acc, precision, recall) dicts
    (nn_A3_metrics.py:127-147)."""
    pred = scores.argmax(axis=-1).reshape(-1)
    tgt = target.reshape(-1)
    f1d, accd, pd, rd = {}, {}, {}, {}
    for k in range(class_num):
        bp = pred == k
        bt = tgt == k
        tp = float((bp & bt).sum())
        fp = float((bp & ~bt).sum())
        fn = float((~bp & bt).sum())
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn) if tp + fn > 0 else 0.0
        pd[k] = prec
        rd[k] = rec
        f1d[k] = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        accd[k] = float((bp == bt).mean())
    return f1d, accd, pd, rd


# ---------------------------------------------------------------------------
# distribution CDFs + image normalizers (nn_A1_tools.py:4-43)
# ---------------------------------------------------------------------------

_A_GD_CDF_CONSTANT = float(np.sqrt(2.0 / np.pi))


def cd_cdf(x: np.ndarray) -> np.ndarray:
    """Cauchy distribution CDF (nn_A1_tools.py:4-8)."""
    return np.arctan(x) / np.pi + 0.5


def a_gd_cdf(x: np.ndarray) -> np.ndarray:
    """Approximate Gaussian CDF: tanh(sqrt(2/pi) x)/2 + 0.5 (nn_A1_tools.py:11-16)."""
    return np.tanh(_A_GD_CDF_CONSTANT * x) / 2.0 + 0.5


def standardize_bchw(img: np.ndarray) -> np.ndarray:
    """Channel-wise (x - 0.5) / 0.5 normalization (nn_A1_tools.py:28-31)."""
    return (img - 0.5) / 0.5


def scale01_bchw(img: np.ndarray) -> np.ndarray:
    """Per-sample-per-channel min-max rescale to [0, 1] over (H, W)
    (nn_A1_tools.py:34-43; returned functionally instead of mutated
    in place — identical values, degenerate H*W==1 passes through)."""
    if img.shape[-2] * img.shape[-1] <= 1:
        return img
    vmax = img.max(axis=(-2, -1), keepdims=True)
    vmin = img.min(axis=(-2, -1), keepdims=True)
    return 1.0 - (vmax - img) / (vmax - vmin)


# ---------------------------------------------------------------------------
# early stopping (nn_A4_earlystop.py:4-33)
# ---------------------------------------------------------------------------

class EarlyStopMin:
    def __init__(self):
        self.loss_min = np.inf

    def check(self, val_loss: float) -> bool:
        res = val_loss < self.loss_min
        self.loss_min = min(val_loss, self.loss_min)
        return res


class EarlyStopMax:
    def __init__(self):
        self.loss_max = -np.inf

    def check(self, val_loss: float) -> bool:
        res = val_loss > self.loss_max
        self.loss_max = max(val_loss, self.loss_max)
        return res


# ---------------------------------------------------------------------------
# timers (utility/watch.py:6-39)
# ---------------------------------------------------------------------------

class Watch:
    """Accumulating stopwatch."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        return dt


def watch_time(fn: Callable) -> Callable:
    """Decorator printing wall time per call."""

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        print(f"[watch] {fn.__name__}: {time.perf_counter() - t0:.4f}s")
        return out

    return wrapped
