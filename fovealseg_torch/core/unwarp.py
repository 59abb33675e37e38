"""Inverse foveated warp and hole fill (counterpart of
``fovealseg_tpu/core/unwarp.py``).

A hole pixel (one no task pixel landed on) takes its nearest landed pixel's
value, found by the jump flood (``ops/jfa.py``); the full-res result is then
one row gather (``ops/gather.py``) from task space:

* argmax serving (``unwarp_argmax_scatter``): the task-space argmax rides the
  landing scatter as the low bits of a (flat task index * M + class) key, and
  the class-mode flood (K1) carries each class id to every pixel;
* score maps and labels (``unwarp_prediction_fast``, ``unwarp_labels_fast``):
  the payload flood (K2, or K3) carries the flat task index, and K5 gathers
  the half-pixel-averaged scores or the labels at it;
* coordinate and value fills (``unwarp_prediction``, ``fill_*``): the seed
  flood (K4) gives each pixel its nearest landed pixel, and K5 gathers the
  inverse grid or the values there; 'BI'/'tri' first splat landed values
  over a 5x5 window and fill only what the splat does not reach.

The JAX package pads canvases to the TPU's (8, 128) tile before its flood
(``_pad_to_vreg``); the port floods the canvas as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fovealseg_torch.core.grid import landing_scatter_max
from fovealseg_torch.core.warp import grid_sample
from fovealseg_torch.ops.gather import row_gather
from fovealseg_torch.ops.jfa import (
    REL_MAX_PAY_BITS,
    full_rounds,
    nearest_class,
    nearest_payload,
    nearest_payload_packed,
    nearest_seed,
)


def _gather_rows_flat(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, T, C] gathered at idx [B, N] int32 -> [B, N, C] (K5)."""
    return row_gather(values.contiguous(), idx.contiguous())


def jfa_rounds_from_grid(grid: torch.Tensor, seg_hw: tuple[int, int]) -> torch.Tensor:
    """Jump-flood round count bounded by the forward grid's geometry: every
    canvas pixel lies within one warped cell of the landing mesh, so
    rounds = ceil(log2(max cell diagonal + 1)) + 1, clipped to
    [2, full]. Returns an int32 scalar tensor on the grid's device (no host
    synchronisation)."""
    hs, ws = seg_hw
    u = (grid[..., 0] + 1.0) * 0.5 * (ws - 1)
    v = (grid[..., 1] + 1.0) * 0.5 * (hs - 1)
    du_x = torch.abs(torch.diff(u, dim=2))
    dv_x = torch.abs(torch.diff(v, dim=2))
    du_y = torch.abs(torch.diff(u, dim=1))
    dv_y = torch.abs(torch.diff(v, dim=1))
    gap_x2 = torch.max(du_x * du_x + dv_x * dv_x)
    gap_y2 = torch.max(du_y * du_y + dv_y * dv_y)
    diag = torch.sqrt(gap_x2 + gap_y2)
    r = torch.ceil(torch.log2(torch.clamp(diag, min=1.0) + 1.0)) + 1.0
    return torch.clamp(r.to(torch.int32), 2, full_rounds(hs, ws))


def halfpixel_avg(pred: torch.Tensor) -> torch.Tensor:
    """P2[i, j] = mean of pred[{i-1, i} x {j-1, j}] with out-of-range taps
    contributing 0 (torch ``grid_sample``'s zero-padded bilinear sample at
    half-integer coordinates). pred: [B, h, w, C]."""
    p = F.pad(pred, (0, 0, 1, 0, 1, 0))
    h, w = pred.shape[1], pred.shape[2]
    return 0.25 * (p[:, :h, :w] + p[:, :h, 1:] + p[:, 1:, :w] + p[:, 1:, 1:])


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift [B, H, W, ...] by (dy, dx) with edge clamping:
    out[:, r, c] = x[:, clip(r + dy), clip(c + dx)] (unlike the jump flood,
    whose out-of-range candidates are invalid)."""
    h, w = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    ix = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[:, iy][:, :, ix]


def _nearest_seed(valid: torch.Tensor, num_iters: int | None = None) -> torch.Tensor:
    """Flat index y*W + x of each pixel's nearest valid pixel (K4)."""
    return nearest_seed(valid, num_iters)


def _nearest_payload(valid: torch.Tensor, payload: torch.Tensor,
                     num_iters: int | None = None, rounds=None,
                     cls_bits: int | None = None,
                     pay_bits: int | None = None) -> torch.Tensor:
    """Payload-carrying jump-flood dispatch, as the JAX package's: ``cls_bits``
    (payload < 2**cls_bits) -> K1; ``pay_bits`` <= 13 -> K2 (which itself
    goes to K3 past 7 host-known rounds); otherwise K3. ``rounds`` (int32
    device scalar) overrides ``num_iters``; both None runs the full chain."""
    r = rounds if rounds is not None else num_iters
    if cls_bits is not None:
        return nearest_class(valid, payload, cls_bits, r)
    if pay_bits is not None and pay_bits <= REL_MAX_PAY_BITS:
        return nearest_payload_packed(valid, payload, pay_bits, r)
    return nearest_payload(valid, payload, r)


def argmax_landing_seeds(pred: torch.Tensor, grid: torch.Tensor, seg_hw: tuple[int, int]):
    """The jump flood's seeds for argmax serving: (valid [B, Hs, Ws] bool,
    class ids [B, Hs, Ws] int32, cls_bits). Each task pixel's half-pixel
    argmax rides its scatter key's low bits, so the collision winner is the
    one ``inverse_grid_index`` picks (the largest task index)."""
    b, th, tw, c = pred.shape
    m = 1 << max(1, (c - 1).bit_length())  # next pow2 > num_class - 1
    if th * tw * m >= 2**31:
        raise ValueError("combined scatter key overflows int32")
    cls2 = torch.argmax(halfpixel_avg(pred), dim=-1).to(torch.int32)
    flat_task = torch.arange(th * tw, dtype=torch.int32, device=pred.device)[None]
    combined = flat_task * m + cls2.reshape(b, th * tw)
    canvas = landing_scatter_max(grid, seg_hw, combined)
    valid = canvas >= 0
    return valid, torch.where(valid, canvas % m, 0), m.bit_length() - 1


def unwarp_argmax_scatter(pred: torch.Tensor, grid: torch.Tensor, seg_hw: tuple[int, int],
                          num_iters: int | None = None, rounds=None) -> torch.Tensor:
    """Full-res argmax class map: scatter (task index, class) keys, then the
    class-mode jump flood carries the class ids to every canvas pixel.

    pred: [B, th, tw, C]; grid: forward warp grid [B, th, tw, 2].
    Returns [B, Hs, Ws] int32 class ids."""
    valid, cls_canvas, cls_bits = argmax_landing_seeds(pred, grid, seg_hw)
    return _nearest_payload(valid, cls_canvas, num_iters, rounds, cls_bits=cls_bits)


def unwarp_prediction_fast(pred: torch.Tensor, task_idx: torch.Tensor, valid: torch.Tensor,
                           num_iters: int | None = None, rounds=None,
                           gather_bf16: bool = False, gather_impl: str = "xla") -> torch.Tensor:
    """Exact fast inverse warp of a score map: the scatter-built inverse grid
    holds half-integer task coordinates, so the bilinear sample there is the
    2x2 zero-padded average of ``pred`` at the integer task index. One
    payload flood (K2) and one row gather (K5).

    ``gather_impl`` ('xla' or 'windowed', ``TPU.scoremap_gather``) picks the
    TPU gather; both are K5 here. ``gather_bf16``
    (``TPU.scoremap_gather_bf16``) rounds the half-pixel-averaged rows to
    bf16 before the gather with 'xla', as the JAX package does; K5 then
    gathers them as f32 rows, whose values are exact in bf16, so the result
    is the JAX package's. With 'windowed' it is ignored, as on the JAX
    package's Pallas path.

    pred: [B, th, tw, C]; task_idx/valid from ``core.grid.inverse_grid_index``.
    Returns [B, Hs, Ws, C] of pred's dtype."""
    if gather_impl not in ("xla", "windowed"):
        raise ValueError(f"Unknown TPU.scoremap_gather: {gather_impl!r}")
    b, th, tw, c = pred.shape
    hs, ws = task_idx.shape[1], task_idx.shape[2]
    tidx = _nearest_payload(valid, task_idx, num_iters, rounds,
                            pay_bits=(th * tw - 1).bit_length())
    p2 = halfpixel_avg(pred.float()).reshape(b, th * tw, c)
    if gather_bf16 and gather_impl == "xla":
        p2 = p2.to(torch.bfloat16).float()
    out = _gather_rows_flat(p2, tidx.reshape(b, hs * ws))
    return out.reshape(b, hs, ws, c).to(pred.dtype)


def unwarp_argmax_fast(pred: torch.Tensor, task_idx: torch.Tensor, valid: torch.Tensor,
                       num_iters: int | None = None, rounds=None) -> torch.Tensor:
    """Full-res argmax class map, the argmax of ``unwarp_prediction_fast``
    taken in task space (argmax commutes with the row gather): K2 + K5 of
    one int32 channel. Returns [B, Hs, Ws] int32."""
    b, th, tw, _ = pred.shape
    hs, ws = task_idx.shape[1], task_idx.shape[2]
    tidx = _nearest_payload(valid, task_idx, num_iters, rounds,
                            pay_bits=(th * tw - 1).bit_length())
    cls2 = torch.argmax(halfpixel_avg(pred), dim=-1).to(torch.int32)
    out = _gather_rows_flat(cls2.reshape(b, th * tw, 1), tidx.reshape(b, hs * ws))
    return out.reshape(b, hs, ws)


def unwarp_labels_fast(labels: torch.Tensor, task_idx: torch.Tensor, valid: torch.Tensor,
                       num_iters: int | None = None, rounds=None) -> torch.Tensor:
    """Nearest label round trip: each full-res pixel takes the label of the
    task pixel whose forward warp landed on it; holes take their nearest
    landed pixel's. labels: [B, th, tw, C] float32 or int32 -> [B, Hs, Ws, C]."""
    b, th, tw, c = labels.shape
    hs, ws = task_idx.shape[1], task_idx.shape[2]
    tidx = _nearest_payload(valid, task_idx, num_iters, rounds,
                            pay_bits=(th * tw - 1).bit_length())
    out = _gather_rows_flat(labels.reshape(b, th * tw, c), tidx.reshape(b, hs * ws))
    return out.reshape(b, hs, ws, c)


def fill_grid_nearest(grid_inv: torch.Tensor, valid: torch.Tensor,
                      num_iters: int | None = None) -> torch.Tensor:
    """Replace the holes of grid_inv [B, H, W, 2] by the nearest valid
    pixel's coordinates (K4 + K5)."""
    b, h, w, _ = grid_inv.shape
    idx = _nearest_seed(valid, num_iters)
    out = _gather_rows_flat(grid_inv.reshape(b, h * w, 2), idx.reshape(b, h * w))
    return out.reshape(b, h, w, 2)


def fill_values_nearest(values: torch.Tensor, valid: torch.Tensor,
                        num_iters: int | None = None) -> torch.Tensor:
    """Nearest-fill per-pixel values [B, H, W, C] at hole pixels (K4 + K5)."""
    b, h, w, c = values.shape
    idx = _nearest_seed(valid, num_iters)
    out = _gather_rows_flat(values.reshape(b, h * w, c), idx.reshape(b, h * w))
    return out.reshape(b, h, w, c)


def fill_values_splat(values: torch.Tensor, valid: torch.Tensor, radius: int = 2,
                      num_iters: int | None = None) -> torch.Tensor:
    """Smooth fill ('BI'/'tri'): a normalized Gaussian splat of the valid
    values over a (2r+1)^2 window, accumulated shift by shift in the JAX
    package's order; pixels no valid value reaches take the nearest fill."""
    vf = valid.to(values.dtype)[..., None]
    num = values * vf
    den = vf
    sigma = max(radius / 1.5, 0.5)
    acc_n = torch.zeros_like(num)
    acc_d = torch.zeros_like(den)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            wgt = math.exp(-(dy * dy + dx * dx) / (2 * sigma * sigma))
            acc_n = acc_n + wgt * _shift2d(num, dy, dx)
            acc_d = acc_d + wgt * _shift2d(den, dy, dx)
    smooth = acc_n / torch.clamp(acc_d, min=1e-8)
    reached = acc_d[..., 0] > 1e-8
    far = fill_values_nearest(values * vf, valid, num_iters)
    out = torch.where(reached[..., None], smooth, far)
    return torch.where(valid[..., None], values, out)


def unwarp_prediction(pred: torch.Tensor, grid_inv: torch.Tensor, valid: torch.Tensor,
                      interp: str = "nearest", num_iters: int | None = None) -> torch.Tensor:
    """Inverse-warp task-space values [B, h, w, C] to full resolution through
    ``grid_inv`` (NaN at holes). 'nearest': every hole adopts its nearest
    valid pixel's coordinates, then one bilinear sample warps and fills
    together. 'BI'/'tri': sample at the valid pixels, then the splat fill."""
    grid_safe = torch.where(torch.isnan(grid_inv), 0.0, grid_inv)
    if interp == "nearest":
        return grid_sample(pred, fill_grid_nearest(grid_safe, valid, num_iters))
    if interp not in ("BI", "tri"):
        raise ValueError(f"Unknown rev_deform_interp: {interp!r}")
    sampled = grid_sample(pred, grid_safe)
    sampled = sampled * valid[..., None].to(sampled.dtype)
    return fill_values_splat(sampled, valid, num_iters=num_iters)
