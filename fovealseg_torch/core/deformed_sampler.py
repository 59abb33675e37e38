"""The DynamicFocus deformed sampler (counterpart of
``fovealseg_tpu/core/deformed_sampler.py``).

The sampling grid is the Gaussian-window expectation of the coordinates,
weighted by the deformation map. As in the JAX package, the window sums are
three separable "valid" Gaussian convolutions, each a pair of banded matrix
products (the sum of the coordinates over a symmetric window centred on
``i`` is ``K^2 * i``, so the reference's per-element eps folds in exactly):

  E[coord] = (conv(dm * coord, k) + eps * K^2 * centre) /
             (conv(dm, k) + eps * K^2)

The products run in full f32 (no TF32), as the JAX package's run at
``Precision.HIGHEST``. ``int_round_scale_grid`` snaps the grid to canvas
pixels, and ``deformed_unsampler`` scatters sampled values back to the
canvas and fills the holes with the nearest landed pixel's value through
``core/unwarp.py::fill_values_nearest`` (K4, then K5, on the card).

The channels are (row, col), not ``grid_sample``'s (x, y).
"""

from __future__ import annotations

import numpy as np
import torch

from fovealseg_torch.core.interpolate import eager_cache, full_f32_matmul
from fovealseg_torch.core.unwarp import fill_values_nearest


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """The 1-D factor of the reference's normalised 2-D Gaussian (the kernel
    is outer(g, g) / sum, separable because exp(-(x^2+y^2)) factorises)."""
    coords = np.linspace(-(size // 2), size // 2, size)
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@eager_cache(maxsize=16)
def _band(n_in: int, k: int, device: torch.device) -> torch.Tensor:
    """The [n_in - k + 1, n_in] band matrix of a valid convolution with the
    size-``k`` Gaussian of :func:`get_grid` (sigma ``k // 2``)."""
    g = gaussian_kernel_1d(k, sigma=k // 2)
    m = np.zeros((n_in - k + 1, n_in), dtype=np.float32)
    for r in range(n_in - k + 1):
        m[r, r:r + k] = g
    return torch.from_numpy(m).to(device)


def _sep_conv_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, HP, WP, C] -> [B, HP-k+1, WP-k+1, C]: the valid separable
    convolution with :func:`get_grid`'s Gaussian on both axes, rows first
    (the JAX package's einsum order)."""
    mh = _band(x.shape[1], k, x.device)
    mw = _band(x.shape[2], k, x.device)
    x = torch.einsum("bhwc,oh->bowc", x, mh)
    return torch.einsum("bhwc,ow->bhoc", x, mw)


def get_grid(dm: torch.Tensor, sample_hw: tuple[int, int], kernel_size: int = 65,
             eps: float = 1e-6) -> torch.Tensor:
    """dm: the padded deformation map [B, HS+2p, WS+2p, 1] (p = kernel_size
    // 2). Returns the grid [B, HS, WS, 2], channels (row, col) in [-1, 1]."""
    hs, ws = sample_hw
    pad = kernel_size // 2
    if dm.shape[1] != hs + 2 * pad or dm.shape[2] != ws + 2 * pad:
        raise ValueError(f"deformation map {tuple(dm.shape)} is not {sample_hw} padded by {pad}")
    k2 = float(kernel_size * kernel_size)
    dev = dm.device
    dm = dm.to(torch.float32)
    rows = (torch.arange(hs + 2 * pad, dtype=torch.float32, device=dev) - pad)[None, :, None, None]
    cols = (torch.arange(ws + 2 * pad, dtype=torch.float32, device=dev) - pad)[None, None, :, None]
    with full_f32_matmul():
        denom = _sep_conv_valid(dm, kernel_size) + eps * k2
        num_r = (_sep_conv_valid(dm * rows, kernel_size)
                 + eps * k2 * torch.arange(hs, dtype=torch.float32, device=dev)[None, :, None, None])
        num_c = (_sep_conv_valid(dm * cols, kernel_size)
                 + eps * k2 * torch.arange(ws, dtype=torch.float32, device=dev)[None, None, :, None])
    er = num_r / denom / (hs - 1.0) * 2.0 - 1.0
    ec = num_c / denom / (ws - 1.0) * 2.0 - 1.0
    return torch.cat([er, ec], dim=-1)


def int_round_scale_grid(grid: torch.Tensor, canvas_hw: tuple[int, int]) -> torch.Tensor:
    """The [-1, 1] grid -> clipped integer canvas coordinates [..., 2] int32
    (row, col). The coordinates are >= 0, so the cast's truncation floors
    them, as the JAX package's ``astype(int32)`` does."""
    h, w = canvas_hw
    r = torch.clamp(0.5 * (grid[..., 0] + 1.0) * (h - 1), 0, h - 1)
    c = torch.clamp(0.5 * (grid[..., 1] + 1.0) * (w - 1), 0, w - 1)
    return torch.stack([r, c], dim=-1).to(torch.int32)


def deformed_unsampler(labels: torch.Tensor, int_grid: torch.Tensor,
                       canvas_hw: tuple[int, int]) -> torch.Tensor:
    """Scatter the sampled values ``labels`` [B, HS, WS, K] to the canvas
    positions ``int_grid`` [B, HS, WS, 2] (row, col), then give every pixel
    that no sample landed on its nearest landed pixel's value (K4 + K5).

    A pixel that several samples land on takes the one with the largest
    flat source index (the reference's last write in source order): a
    scatter-max of the source index, deterministic for integers, then a
    gather of the winner's values."""
    b, hs, ws, k = labels.shape
    h, w = canvas_hw
    dev = labels.device
    flat_tgt = (int_grid[..., 0].to(torch.int64) * w + int_grid[..., 1]).reshape(b, hs * ws)
    src = torch.arange(hs * ws, dtype=torch.int32, device=dev).expand(b, hs * ws)
    win = torch.full((b, h * w), -1, dtype=torch.int32, device=dev)
    win = win.scatter_reduce(1, flat_tgt, src, reduce="amax")
    hit = win >= 0
    bidx = torch.arange(b, device=dev)[:, None]
    canvas = labels.reshape(b, hs * ws, k)[bidx, win.clamp(min=0)]
    canvas = torch.where(hit[..., None], canvas, torch.zeros_like(canvas))
    return fill_values_nearest(canvas.reshape(b, h, w, k), hit.reshape(b, h, w))
