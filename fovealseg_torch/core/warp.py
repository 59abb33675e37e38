"""Foveated resampling (counterpart of ``fovealseg_tpu/core/warp.py``).

The JAX package reproduces ``F.grid_sample(padding_mode='zeros',
align_corners=False)`` by hand on NHWC. Bilinear here is that call on an
NCHW view. Nearest is computed by hand, as the JAX package pins it: torch's
own nearest mode rounds half to even on the CPU and half away from zero on
CUDA, and the clamped grid reaches the tie ix = -0.5 at its border, where
half away from zero gives -1, i.e. zero padding. The packed-neighbourhood
form of the JAX package is a TPU gather workaround and has no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_nchw(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of NCHW ``img`` at ``grid`` [B, Ho, Wo, 2] -> NCHW.

    Coordinates and taps are computed in f32 whatever ``img``'s dtype (as
    the JAX package computes the coordinates in f32); the result is cast back
    to ``img``'s dtype."""
    out = F.grid_sample(img.float(), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.to(img.dtype)


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
    return grid_sample_nchw(img.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)
