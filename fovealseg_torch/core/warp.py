"""Foveated resampling (counterpart of ``fovealseg_tpu/core/warp.py``).

The JAX package reproduces ``F.grid_sample(padding_mode='zeros',
align_corners=False)`` by hand on NHWC. Bilinear on a float32 image is that
call on an NCHW view. On a 2-byte image (bfloat16) the JAX package blends in
the image's dtype, rounding after every operation
(``fovealseg_tpu/core/warp.py::_grid_sample_packed``); ``_grid_sample_rounded``
repeats that arithmetic op by op, so the result is bit-equal. Its single
packed gather is a TPU gather workaround: four plain gathers of the
zero-padded image read the same taps. Nearest is computed by hand, as the
JAX package pins it: torch's own nearest mode rounds half to even on the CPU
and half away from zero on CUDA, and the clamped grid reaches the tie
ix = -0.5 at its border, where half away from zero gives -1, i.e. zero
padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _grid_sample_rounded(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of NHWC ``img`` in its own (2-byte) dtype, rounded where
    the JAX package rounds: coordinates and ``floor`` in f32, the fractions
    cast to ``img.dtype``, each tap weight ``(wy * wx) * aligned`` and each
    product and partial sum of the four taps rounded in turn. Taps are read
    from the zero-padded image at the clamped (x0 + 1, y0 + 1), as the JAX
    package's packed gather reads them, so off-canvas taps are zeros."""
    b, h, w, c = img.shape
    dt = img.dtype
    ix = ((grid[..., 0].float() + 1.0) * w - 1.0) / 2.0
    iy = ((grid[..., 1].float() + 1.0) * h - 1.0) / 2.0
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    wx1, wy1 = (ix - x0f).to(dt), (iy - y0f).to(dt)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    aligned = ((x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)).to(dt)
    padded = F.pad(img, (0, 0, 1, 1, 1, 1)).reshape(b, (h + 2) * (w + 2), c)
    corner = (y0 + 1).clamp(0, h) * (w + 2) + (x0 + 1).clamp(0, w)

    def tap(offset: int, weight: torch.Tensor) -> torch.Tensor:
        flat = (corner + offset).reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(padded, 1, flat).reshape(*grid.shape[:3], c)
        return v * (weight * aligned)[..., None]

    return (tap(0, wy0 * wx0) + tap(1, wy0 * wx1)
            + tap(w + 2, wy1 * wx0) + tap(w + 3, wy1 * wx1))


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5)).to(torch.int64)


def grid_sample_nearest(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Nearest sample of NHWC ``img`` at ``grid`` [B, Ho, Wo, 2] with zero
    padding; the index is ix = ((x + 1) * W - 1) / 2 in f32, rounded half
    away from zero, on every device."""
    b, h, w, c = img.shape
    ix = ((grid[..., 0].float() + 1.0) * w - 1.0) / 2.0
    iy = ((grid[..., 1].float() + 1.0) * h - 1.0) / 2.0
    x0, y0 = _round_half_away(ix), _round_half_away(iy)
    inside = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    flat = (y0.clamp(0, h - 1) * w + x0.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, c)
    out = torch.gather(img.reshape(b, h * w, c), 1, flat).reshape(*grid.shape[:3], c)
    return out * inside[..., None].to(img.dtype)


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] at ``grid`` [B,Ho,Wo,2] ((x,y) in [-1,1])."""
    if mode == "nearest":
        return grid_sample_nearest(img, grid)
    if mode != "bilinear":
        raise ValueError(f"Unsupported grid_sample mode: {mode}")
    if img.element_size() <= 2:
        return _grid_sample_rounded(img, grid)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)
