"""Learn-to-downsample grid solver (counterpart of ``fovealseg_tpu/core/grid.py``).

The padded saliency map and its products with the coordinate basis are
convolved with a separable Gaussian, written as two dense banded matrix
products; their ratio, mapped to [-1, 1] and clamped, is the sampling grid.
The JAX package runs those products at ``Precision.HIGHEST``; here they run
as plain f32 matrix products under :func:`full_f32_matmul`, which switches
TF32 off for their duration whatever the caller's global setting.

``landing_scatter_max`` is the inverse warp's landing convention: truncated
integer coordinates of the unnormalized grid, collisions resolved by a max
over the scattered values (``scatter_reduce_(reduce='amax')`` on a canvas of
-1).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from fovealseg_torch.core.interpolate import _linear_resize_matrix, full_f32_matmul, resize_bilinear


def make_gaussian_1d(size: int, fwhm: float, center: float | None = None) -> np.ndarray:
    """1-D factor of the reference's ``makeGaussian``: the 2-D kernel is
    ``exp(-4 ln2 ((x-x0)^2+(y-y0)^2)/fwhm^2)`` = outer(g, g)."""
    x = np.arange(0, size, 1, dtype=np.float64)
    x0 = size // 2 if center is None else center
    return np.exp(-4.0 * np.log(2.0) * (x - x0) ** 2 / fwhm**2).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _gaussian_factors(pad_x: int, pad_y: int, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Row/col 1-D kernels; a bilinear stretch of a separable kernel stays
    separable, so the (2px+1, 2py+1) kernel is an outer product."""
    g = make_gaussian_1d(2 * pad_x + 1, fwhm=radius)
    if pad_y == pad_x:
        gy = g
    else:
        m = _linear_resize_matrix(2 * pad_x + 1, 2 * pad_y + 1)
        gy = (m @ g).astype(np.float32)
    return g, gy


def pad_saliency(xs: torch.Tensor, pad_x: int, pad_y: int, mode: str = "replication"):
    """Pad [B,H,W,1] saliency by (pad_x rows, pad_y cols); modes mirror
    TRAIN.def_saliency_pad_mode."""
    torch_mode = {"replication": "replicate", "reflect": "reflect", "zero": "constant"}.get(mode)
    if torch_mode is None:
        raise ValueError(f"Unknown def_saliency_pad_mode: {mode}")
    x = xs.permute(0, 3, 1, 2)
    x = F.pad(x, (pad_y, pad_y, pad_x, pad_x), mode=torch_mode)
    return x.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=16)
def _solver_tensors(solver: "GridSolver", device: torch.device):
    """(u, v, mh, mw) f32 tensors on ``device``: the coordinate basis and the
    two banded 1-D Gaussian matrices."""
    gx, gy = _gaussian_factors(solver.pad_x, solver.pad_y, solver.radius)
    mh = np.zeros((solver.grid_h, solver.global_h), dtype=np.float32)
    for r in range(solver.grid_h):
        mh[r, r : r + 2 * solver.pad_x + 1] = gx
    mw = np.zeros((solver.grid_w, solver.global_w), dtype=np.float32)
    for r in range(solver.grid_w):
        mw[r, r : r + 2 * solver.pad_y + 1] = gy
    u, v = solver.p_basis()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (u, v, mh, mw))


@dataclasses.dataclass(frozen=True)
class GridSolver:
    """Static geometry for one (saliency size, radius, aspect) configuration."""

    grid_h: int
    grid_w: int
    pad_x: int  # rows padding = MODEL.gaussian_radius
    pad_y: int  # cols padding = int(gaussian_ap * pad_x)
    radius: float  # fwhm of the Gaussian

    @property
    def global_h(self) -> int:
        return self.grid_h + 2 * self.pad_x

    @property
    def global_w(self) -> int:
        return self.grid_w + 2 * self.pad_y

    def p_basis(self) -> tuple[np.ndarray, np.ndarray]:
        """(u, v) coordinate basis over the padded canvas, [GH, GW] each."""
        i = np.arange(self.global_h, dtype=np.float32)[:, None]
        j = np.arange(self.global_w, dtype=np.float32)[None, :]
        u = np.broadcast_to((j - self.pad_y) / (self.grid_w - 1.0), (self.global_h, self.global_w))
        v = np.broadcast_to((i - self.pad_x) / (self.grid_h - 1.0), (self.global_h, self.global_w))
        return u.astype(np.float32), v.astype(np.float32)

    def solve(self, xs_hm: torch.Tensor) -> torch.Tensor:
        """Padded saliency [B, GH, GW, 1] -> raw grid [B, grid_h, grid_w, 2]
        with last dim (x, y) in [-1, 1]."""
        u, v, mh, mw = _solver_tensors(self, xs_hm.device)
        xs_hm = xs_hm.to(torch.float32)
        stacked = torch.cat([xs_hm, xs_hm * u[None, :, :, None], xs_hm * v[None, :, :, None]], dim=-1)
        with full_f32_matmul():
            f = torch.einsum("bhwc,oh->bowc", stacked, mh)
            f = torch.einsum("bhwc,ow->bhoc", f, mw)
        denom = f[..., 0:1] + 1e-12
        xg = f[..., 1:2] / denom * 2.0 - 1.0
        yg = f[..., 2:3] / denom * 2.0 - 1.0
        return torch.clamp(torch.cat([xg, yg], dim=-1), -1.0, 1.0)

    def upsample_grid(self, grid: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """Bilinear-resize a [B, h, w, 2] grid to ``out_hw``."""
        return resize_bilinear(grid, out_hw)

    def create_grid(self, xs_hm: torch.Tensor, task_hw: tuple[int, int],
                    label_hw: tuple[int, int] | None = None):
        """(grid, grid_y) at task / label resolution; grid_y is resized from
        the task-sized grid, as the reference composes them."""
        grid = self.upsample_grid(self.solve(xs_hm), task_hw)
        label_hw = tuple(label_hw) if label_hw is not None else tuple(task_hw)
        grid_y = grid if label_hw == tuple(task_hw) else self.upsample_grid(grid, label_hw)
        return grid, grid_y


def landing_scatter_max(grid: torch.Tensor, seg_hw: tuple[int, int],
                        values: torch.Tensor) -> torch.Tensor:
    """Scatter per-task-pixel ``values`` [B, th*tw] int32 to the full-res
    landing positions of the forward grid, max-reducing collisions.
    Returns [B, Hs, Ws] int32 with -1 where nothing landed."""
    b, th, tw, _ = grid.shape
    hs, ws = seg_hw
    u = torch.floor((grid[..., 0] + 1.0) / 2.0 * (ws - 1)).to(torch.int64)
    v = torch.floor((grid[..., 1] + 1.0) / 2.0 * (hs - 1)).to(torch.int64)
    target = (v * ws + u).reshape(b, th * tw)
    canvas = torch.full((b, hs * ws), -1, dtype=torch.int32, device=grid.device)
    canvas.scatter_reduce_(1, target, values.to(torch.int32), reduce="amax", include_self=True)
    return canvas.reshape(b, hs, ws)


def inverse_grid_index(grid: torch.Tensor, seg_hw: tuple[int, int]):
    """(task_idx [B, Hs, Ws] int32 with -1 at holes, valid bool mask)."""
    b, th, tw, _ = grid.shape
    flat_task = torch.arange(th * tw, dtype=torch.int32, device=grid.device)[None].expand(b, th * tw)
    canvas = landing_scatter_max(grid, seg_hw, flat_task)
    return canvas, canvas >= 0


def grid_from_index(canvas: torch.Tensor, valid: torch.Tensor,
                    task_hw: tuple[int, int]) -> torch.Tensor:
    """The inverse grid [B, Hs, Ws, 2] of ``inverse_grid_index``'s output: a
    landed pixel holds the normalized coordinates (j / tw * 2 - 1,
    i / th * 2 - 1) of the task pixel (i, j) that won its landing scatter,
    a hole holds NaN."""
    th, tw = task_hw
    safe = torch.clamp(canvas, min=0)
    gx = torch.where(valid, (safe % tw) / tw * 2.0 - 1.0, float("nan"))
    gy = torch.where(valid, torch.div(safe, tw, rounding_mode="floor") / th * 2.0 - 1.0,
                     float("nan"))
    return torch.stack([gx, gy], dim=-1)


def inverse_grid(grid: torch.Tensor, seg_hw: tuple[int, int]):
    """Scatter-based inverse deformation grid: (grid_inv [B, Hs, Ws, 2] with
    (x, y) in [-1, 1] and NaN at holes, valid [B, Hs, Ws] bool)."""
    canvas, valid = inverse_grid_index(grid, seg_hw)
    return grid_from_index(canvas, valid, (grid.shape[1], grid.shape[2])), valid
