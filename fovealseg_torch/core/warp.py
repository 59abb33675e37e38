"""Foveated resampling (counterpart of ``fovealseg_tpu/core/warp.py``).

The JAX package reproduces ``F.grid_sample(padding_mode='zeros',
align_corners=False)`` by hand on NHWC; here it is that call on an NCHW view.
The packed-neighbourhood form of the JAX package is a TPU gather workaround
and has no counterpart.
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


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` [B,H,W,C] at ``grid`` [B,Ho,Wo,2] ((x,y) in [-1,1])."""
    if mode != "bilinear":
        # mode='nearest' serves the label round trip (y_sampled_reverse),
        # which belongs to the score-map / label inverse-warp slice
        raise NotImplementedError(
            f"grid_sample mode {mode!r} arrives with the label inverse-warp slice")
    return grid_sample_nchw(img.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)
