"""Edge-map targets from labels (counterpart of ``fovealseg_tpu/core/edges.py``).

The reference builds these per sample with PIL: normalise the label, bilinear
downsample, ``ImageFilter.GaussianBlur``, ``ImageFilter.FIND_EDGES``,
upsample to the saliency grid. ``MODEL.gt_gradient`` with
``MODEL.fix_gt_gradient`` drives the grid with this map in place of the
predicted saliency.

As in the JAX package, FIND_EDGES is PIL's exact 3x3 Laplacian on uint8 with
clamping and the 1-px border pasted from the input, and the blur is a true
Gaussian with sigma = radius (PIL approximates it with box blurs). Everything
runs in full f32: on the card TF32 is off for these convolutions, so that it
cannot move a uint8 quantisation step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from fovealseg_torch.core.interpolate import resize_bilinear


@contextlib.contextmanager
def _full_f32_conv():
    """cuDNN convolutions in full f32 (no TF32) inside the block; the
    caller's setting is restored after it."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def _gaussian_taps(radius: float) -> np.ndarray:
    half = max(1, int(np.ceil(3 * radius)))
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * radius**2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, radius: float) -> torch.Tensor:
    """Separable Gaussian blur (sigma = radius, span 3 sigma) of a
    [B, H, W, 1] image: edge padding, then two VALID convolutions."""
    if radius <= 0:
        return img
    g = torch.from_numpy(_gaussian_taps(radius)).to(img.device)
    half = (g.numel() - 1) // 2
    x = img.permute(0, 3, 1, 2)
    x = F.pad(x, (half, half, half, half), mode="replicate")
    with _full_f32_conv():
        x = F.conv2d(x, g.view(1, 1, -1, 1))
        x = F.conv2d(x, g.view(1, 1, 1, -1))
    return x.permute(0, 2, 3, 1)


def pil_find_edges(img01: torch.Tensor) -> torch.Tensor:
    """PIL ``ImageFilter.FIND_EDGES`` on a [B, H, W, 1] image in [0, 1]:
    quantise to uint8, 3x3 Laplacian on the interior, clamp to [0, 255]; the
    1-px border keeps the quantised input, as PIL pastes the source there."""
    u8 = torch.round(torch.clamp(img01, 0.0, 1.0) * 255.0)
    k = torch.full((1, 1, 3, 3), -1.0, dtype=torch.float32, device=img01.device)
    k[0, 0, 1, 1] = 8.0
    with _full_f32_conv():
        out = F.conv2d(u8.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)
    out = torch.clamp(torch.round(out), 0.0, 255.0)
    h, w = img01.shape[1], img01.shape[2]
    border = torch.zeros((1, h, w, 1), dtype=torch.bool, device=img01.device)
    border[:, 0] = border[:, -1] = True
    border[:, :, 0] = border[:, :, -1] = True
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, one ulp off the true quotient
    return torch.where(border, u8, out) / torch.full((), 255.0, device=img01.device)


def edge_target_pil_style(
    y: torch.Tensor,
    saliency_hw: tuple[int, int],
    grid_hw: tuple[int, int],
    blur_radius: float = 1.0,
    softmax: bool = False,
    zero_bound: int = 0,
    eps: float = 1e-12,
) -> torch.Tensor:
    """The PIL-style target chain, batched: per-sample min-max normalise ->
    bilinear downsample to the saliency size -> Gaussian blur -> FIND_EDGES
    -> upsample to the grid -> optional softmax and zero-bound border mask.
    y: [B, H, W] labels or masks -> [B, gh, gw, 1] f32."""
    b = y.shape[0]
    yf = y.to(torch.float32)
    lo = torch.amin(yf.reshape(b, -1), dim=1)[:, None, None]
    hi = torch.amax(yf.reshape(b, -1), dim=1)[:, None, None]
    norm = (yf - lo) / torch.clamp(hi - lo, min=eps)
    low = resize_bilinear(norm[..., None], saliency_hw)
    low = gaussian_blur(low, blur_radius)
    edges = pil_find_edges(low)
    xs_t = resize_bilinear(edges, grid_hw)
    if softmax:
        xs_t = torch.softmax(xs_t.reshape(b, -1), dim=-1).reshape(xs_t.shape)
    if zero_bound > 0:
        mask = torch.zeros_like(xs_t)
        mask[:, zero_bound:-zero_bound, zero_bound:-zero_bound, :] = 1.0
        xs_t = xs_t * mask
    return xs_t
