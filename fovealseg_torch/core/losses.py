"""Losses (counterpart of ``fovealseg_tpu/core/losses.py``): NHWC logits
[B, H, W, C] and integer labels [B, H, W], as in the JAX package.

* the training loss: multiclass soft Dice + Focal(gamma=5) + the edge MSE;
* the criterion family: cross entropy, OHEM cross entropy, the score Dice,
  the binary soft Dice, total variation, the Dice coefficient;
* the DynamicFocus family: area-balanced MSE, class-balanced similarity,
  sigmoid cross entropy.

Each is the JAX function's arithmetic in the same order; ``pt`` of the focal
loss is detached, as the JAX package stops its gradient.

The training losses take an optional ``reduce`` (``parallel/mesh.py::
BatchReduce``): a rank that holds one block of the global batch then gives
the global batch's loss, with its per-class sums, extrema and means taken
over the ranks of a data group (the JAX package's GSPMD step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: out-of-range labels give an all-zero row."""
    return (labels.long()[..., None] == torch.arange(c, device=labels.device)).to(dtype)


def _take(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp, labels[..., None], -1)[..., 0]``."""
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


# --------------------------------------------------------------------------
# primary training losses
# --------------------------------------------------------------------------

def dice_loss_multiclass(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 0.0,
                         eps: float = 1e-7, reduce=None) -> torch.Tensor:
    """Soft dice per class over (batch, pixels) of the softmax against the
    one-hot target; classes absent from the target contribute 0; mean over
    all classes. With ``reduce`` the per-class sums are the global batch's."""
    c = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(labels, c, probs.dtype)
    dims = (0, 1, 2)
    intersection = torch.sum(probs * onehot, dim=dims)
    cardinality = torch.sum(probs + onehot, dim=dims)
    count = torch.sum(onehot, dim=dims)
    if reduce is not None:
        intersection, cardinality, count = reduce.sum(
            torch.stack([intersection, cardinality, count])).unbind()
    score = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)
    loss = 1.0 - score
    present = count > 0
    return torch.mean(loss * present.to(loss.dtype))


def _mean(x: torch.Tensor, reduce=None) -> torch.Tensor:
    """The mean of ``x``; with ``reduce``, over the global batch (each rank
    holds an equal block)."""
    return torch.mean(x) if reduce is None else reduce.avg(torch.mean(x))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 5.0,
               reduce=None) -> torch.Tensor:
    """``-(1 - pt)^gamma * log pt``, mean over pixels; ``pt`` is a constant
    for the gradient."""
    logpt = _take(F.log_softmax(logits, dim=-1), labels)
    pt = torch.exp(logpt).detach()
    return _mean(-((1.0 - pt) ** gamma) * logpt, reduce)


def minmax_normalize(x: torch.Tensor, eps: float = 0.0, reduce=None) -> torch.Tensor:
    """Min-max normalisation over the whole tensor (the batch included; with
    ``reduce``, the global batch)."""
    lo = torch.min(x) if reduce is None else reduce.min(x)
    hi = torch.max(x) if reduce is None else reduce.max(x)
    return (x - lo) / (hi - lo + eps)


def edge_loss(saliency: torch.Tensor, target: torch.Tensor, edge_loss_scale=100.0,
              normalize: bool = True, eps: float = 1e-12, reduce=None) -> torch.Tensor:
    """The deformation edge loss: with ``normalize`` (the default
    ``TRAIN.opt_deform_LabelEdge_norm``) ``0.05 * MSE`` of the two globally
    min-max normalised maps times the scale, else the plain MSE times the
    scale. ``edge_loss_scale`` may be a float or a scalar tensor."""
    if normalize:
        saliency = minmax_normalize(saliency, eps, reduce)
        target = minmax_normalize(target, eps, reduce)
    factor = 0.05 if normalize else 1.0
    return factor * _mean((saliency - target) ** 2, reduce) * edge_loss_scale


# --------------------------------------------------------------------------
# criterion family
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = -2,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """Cross entropy with an ignore label (negative labels are ignored too)
    and optional class weights."""
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    nll = -_take(logp, safe)
    mask = (labels != ignore_label) & (labels >= 0)
    w = weight[safe] * mask if weight is not None else mask.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-12)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                       min_kept: int = 100000, ignore_label: int = -1) -> torch.Tensor:
    """Online hard-example mining: keep the pixels whose target-class score
    is below max(thresh, the k-th smallest score) and average their CE."""
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.clamp(torch.where(labels == ignore_label, 0, labels).long(), min=0)
    nll = -_take(logp, safe)
    score = _take(torch.softmax(logits, dim=-1), safe)
    valid = labels != ignore_label
    score_v = torch.where(valid, score, torch.inf).reshape(-1)
    nll_v = torch.where(valid, nll, 0.0).reshape(-1)
    sorted_scores = torch.sort(score_v).values
    k = min(min_kept, score_v.shape[0] - 1)
    threshold = torch.clamp(sorted_scores[k], min=thresh)
    keep = (score_v < threshold) & valid.reshape(-1)
    return torch.sum(nll_v * keep) / torch.clamp(torch.sum(keep), min=1.0)


def dice_loss_scores(scores: torch.Tensor, labels: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Soft dice over raw scores (no softmax), per class over (batch,
    pixels), mean."""
    c = scores.shape[-1]
    onehot = _one_hot(labels, c, scores.dtype)
    dims = (0, 1, 2)
    intersection = torch.sum(scores * onehot, dim=dims)
    cardinality = torch.sum(scores + onehot, dim=dims)
    return 1.0 - torch.mean(2.0 * intersection / (cardinality + eps))


def soft_dice_v1(logits: torch.Tensor, labels: torch.Tensor, p: float = 2.0,
                 smooth: float = 0.0) -> torch.Tensor:
    """Binary sigmoid soft dice."""
    probs = torch.sigmoid(logits)
    numer = torch.sum(probs * labels)
    denor = torch.sum(probs**p + labels**p)
    return 1.0 - (2.0 * numer + smooth) / (denor + smooth)


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation of x [B, H, W, 1]."""
    b, h, w, _ = x.shape
    h_tv = torch.sum(torch.abs(x[:, 1:] - x[:, :-1]))
    w_tv = torch.sum(torch.abs(x[:, :, 1:] - x[:, :, :-1]))
    return (h_tv / ((h - 1) * w) + w_tv / (h * (w - 1))) / b


def dice_coeff(inputs: torch.Tensor, target: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Batch mean of the per-sample binary Dice coefficient."""
    b = inputs.shape[0]
    x = inputs.reshape(b, -1)
    y = target.reshape(b, -1).to(x.dtype)
    inter = torch.sum(x * y, dim=1)
    union = torch.sum(x, dim=1) + torch.sum(y, dim=1) + eps
    return torch.mean((2.0 * inter + eps) / union)


# --------------------------------------------------------------------------
# DynamicFocus family
# --------------------------------------------------------------------------

def bmse_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Area-balanced MSE: foreground and background MSE, each over its own
    area, averaged 50/50."""
    ones = target >= 0.5
    zeros = ~ones
    mse = (pred - target) ** 2
    axes = (-2, -1)
    mse_one = torch.sum(mse * ones, dim=axes) / (torch.sum(ones, dim=axes) + eps)
    mse_zero = torch.sum(mse * zeros, dim=axes) / (torch.sum(zeros, dim=axes) + eps)
    return torch.mean(0.5 * mse_one + 0.5 * mse_zero)


def bcosim_loss(scores: torch.Tensor, target: torch.Tensor, class_num: int,
                eps: float = 1e-6) -> torch.Tensor:
    """1 - the mean over present classes of the mean target-class score.
    scores [N, K], target [N] (any shape that flattens to N)."""
    tgt = target.reshape(-1)
    picked = torch.gather(scores, -1, tgt.long()[:, None])[:, 0]
    onehot = _one_hot(tgt, class_num, scores.dtype)
    per_class_sum = onehot.T @ picked
    per_class_cnt = torch.sum(onehot, dim=0)
    present = per_class_cnt > 0
    k_loss = per_class_sum / (per_class_cnt + eps)
    return 1.0 - torch.sum(k_loss * present) / torch.clamp(torch.sum(present), min=1.0)


def wce_loss(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sigmoid of the mean cross entropy."""
    nll = -torch.gather(F.log_softmax(scores, dim=-1), -1, target.reshape(-1).long()[:, None])
    return torch.sigmoid(torch.mean(nll))
