"""Inverse foveated warp for argmax serving (counterpart of
``fovealseg_tpu/core/unwarp.py``, the argmax-scatter path).

The task-space argmax rides the inverse scatter as the low bits of a
(flat task index * M + class) key, and the class-mode jump flood
(``ops/jfa.py``) carries each landed class id to every canvas pixel. The
score-map and label inverse warps (the other jump-flood modes and the row
gather) belong to a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fovealseg_torch.core.grid import landing_scatter_max
from fovealseg_torch.ops.jfa import full_rounds, nearest_class


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


def _nearest_payload(valid: torch.Tensor, payload: torch.Tensor,
                     num_iters: int | None = None, rounds=None,
                     cls_bits: int | None = None) -> torch.Tensor:
    """Payload-carrying jump-flood dispatch. ``rounds`` (int32 device scalar)
    overrides ``num_iters``; both None runs the full chain. Only the
    class mode (``cls_bits``) is on this slice's path."""
    if cls_bits is None:
        raise NotImplementedError(
            "the wide-payload jump flood (the TPU package's 'relpay'/'payload' modes) "
            "arrives with the score-map inverse-warp slice")
    return nearest_class(valid, payload, cls_bits, rounds if rounds is not None else num_iters)


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
