"""Gaze-conditioning maps (counterpart of ``fovealseg_tpu/core/gaze.py``):
the focus map of the deform forward (``focus_distance_map``) and the two
alternative maps of the reference (``focus_gaussian_map``, the DynamicFocus
``gen_focus_Gaussian_HxW``; ``cosine_decay_map``, ``create_map``). Each
takes ``focus_point`` [B, 2], (row, col) in [0, 1], and returns [B, h, w, 1]
float32 on its device."""

from __future__ import annotations

import math

import torch


def grid_coords(h: int, w: int, dtype=torch.float32, device=None):
    """(row, col) index maps of shape [h, w]."""
    rows = torch.arange(h, dtype=dtype, device=device)[:, None] * torch.ones(
        (1, w), dtype=dtype, device=device)
    cols = torch.ones((h, 1), dtype=dtype, device=device) * torch.arange(
        w, dtype=dtype, device=device)[None, :]
    return rows, cols


def _gaze_d2(focus_point: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Squared pixel distance of every pixel to the gaze, [B, h, w]."""
    rows, cols = grid_coords(h, w, device=focus_point.device)
    fp = focus_point.to(torch.float32)
    hidx = fp[:, 0] * (h - 1.0)
    widx = fp[:, 1] * (w - 1.0)
    return (rows[None] - hidx[:, None, None]) ** 2 + (cols[None] - widx[:, None, None]) ** 2


def focus_distance_map(focus_point: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized squared gaze-distance map, ``(dist / sqrt(h^2 + w^2))**2``."""
    max_dist2 = float(h * h + w * w)
    return (_gaze_d2(focus_point, h, w) / max_dist2)[..., None]


def focus_gaussian_map(focus_point: torch.Tensor, h: int, w: int,
                       std: float = 512.0) -> torch.Tensor:
    """Gaussian of the gaze distance, peak-normalised to 1."""
    dist = torch.sqrt(_gaze_d2(focus_point, h, w))
    coeff = 1.0 / (std * math.sqrt(2.0 * math.pi))
    val = coeff * torch.exp(-0.5 * (dist / std) ** 2)
    val = val / torch.amax(val, dim=(1, 2), keepdim=True)
    return val[..., None]


def cosine_decay_map(focus_point: torch.Tensor, h: int, w: int, radius: float = 25.0,
                     max_value: float = 0.5, min_value: float = 0.05) -> torch.Tensor:
    """Cosine decay from ``max_value`` at the gaze to ``min_value`` at
    ``radius``, ``min_value`` beyond it."""
    dist = torch.sqrt(_gaze_d2(focus_point, h, w))
    decay = 0.5 * (1.0 + torch.cos(math.pi * dist / radius))
    val = torch.where(dist <= radius, min_value + (max_value - min_value) * decay,
                      torch.full_like(dist, min_value))
    return val[..., None]
