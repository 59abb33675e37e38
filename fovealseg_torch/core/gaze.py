"""Gaze-conditioning maps (counterpart of ``fovealseg_tpu/core/gaze.py``)."""

from __future__ import annotations

import torch


def focus_distance_map(focus_point: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalized squared gaze-distance map, [B, h, w, 1].

    ``focus_point`` is [B, 2] with (row, col) in [0, 1]; the map is
    ``(dist / sqrt(h^2 + w^2))**2`` as in the JAX function.
    """
    dev = focus_point.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones(
        (1, w), dtype=torch.float32, device=dev)
    cols = torch.ones((h, 1), dtype=torch.float32, device=dev) * torch.arange(
        w, dtype=torch.float32, device=dev)[None, :]
    fp = focus_point.to(torch.float32)
    hidx = fp[:, 0] * (h - 1.0)
    widx = fp[:, 1] * (w - 1.0)
    d2 = (rows[None] - hidx[:, None, None]) ** 2 + (cols[None] - widx[:, None, None]) ** 2
    max_dist2 = float(h * h + w * w)
    return (d2 / max_dist2)[..., None]
