"""Class-mode jump flood: every pixel gets the payload of its nearest valid
seed (counterpart of ``fovealseg_tpu/ops/pallas_jfa.py::nearest_class_pallas``).

``nearest_class`` launches the hand-written CUDA kernel
(``fovealseg_torch/csrc/jfa.cu``) for CUDA tensors and takes the plain
PyTorch version, ``nearest_class_plain``, for CPU tensors. Both reproduce the
Pallas kernel bit for bit: ``rounds`` clipped to [1, full] with
full = ceil(log2(max(H, W))), rounds+1 trips with step
``max((1 << (rounds-1)) >> i, 1)``, the 8 directions applied in sequence
within a trip, out-of-range candidates invalid, strict ``<`` on the squared
integer distance, 0 where no seed exists.

The kernel's launch count is ``nearest_class.launches``: one per call that
launched it.
"""

from __future__ import annotations

import ctypes
import math

import torch

_FAR = 2**31 - 1
_MAX_SIDE = 1 << 15  # positions ride as (y << 16) | x in one int32


def full_rounds(h: int, w: int) -> int:
    """The full jump-flood round count of an H x W canvas."""
    return max(1, math.ceil(math.log2(max(h, w))))


def _check(valid: torch.Tensor, payload: torch.Tensor, cls_bits: int) -> None:
    if valid.dtype != torch.bool or valid.dim() != 3:
        raise ValueError(f"valid must be [B, H, W] bool, got {tuple(valid.shape)} {valid.dtype}")
    if payload.dtype != torch.int32 or payload.shape != valid.shape:
        raise ValueError(f"payload must be int32 of shape {tuple(valid.shape)}, "
                         f"got {tuple(payload.shape)} {payload.dtype}")
    if payload.device != valid.device:
        raise ValueError("valid and payload must be on one device")
    if not 0 < cls_bits < 31:
        raise ValueError(f"cls_bits must be in [1, 30], got {cls_bits}")


def _host_rounds(rounds, full: int) -> int:
    r = full if rounds is None else int(rounds)
    return min(max(r, 1), full)


def _shift(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[:, r, c] = x[:, r + dy, c + dx] where that lies on the canvas, else fill."""
    _, h, w = x.shape
    out = torch.full_like(x, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[:, max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[:, max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def nearest_class_plain(valid: torch.Tensor, payload: torch.Tensor, cls_bits: int,
                        rounds=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on CPU or CUDA tensors.

    ``rounds`` is None (full), an int, or an int32 tensor holding one value
    (read to the host here: this version is the reference, not the path)."""
    _check(valid, payload, cls_bits)
    b, h, w = valid.shape
    r = _host_rounds(rounds, full_rounds(h, w))
    dev = valid.device
    ys = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, w)
    seed_y = torch.where(valid, ys, -1)
    seed_x = torch.where(valid, xs, -1)
    best = torch.where(valid, 0, _FAR).to(torch.int32)
    for i in range(r + 1):
        k = max((1 << (r - 1)) >> i, 1)
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                if sy == 0 and sx == 0:
                    continue
                cy = _shift(seed_y, sy * k, sx * k, -1)
                cx = _shift(seed_x, sy * k, sx * k, -1)
                d = (cy - ys) * (cy - ys) + (cx - xs) * (cx - xs)
                better = (cy >= 0) & (d < best)
                seed_y = torch.where(better, cy, seed_y)
                seed_x = torch.where(better, cx, seed_x)
                best = torch.where(better, d, best)
    flat = (seed_y.clamp(min=0) * w + seed_x.clamp(min=0)).reshape(b, h * w).long()
    out = torch.gather(payload.reshape(b, h * w), 1, flat).reshape(b, h, w)
    return torch.where(seed_y >= 0, out, 0)


def _rounds_tensor(rounds, full: int, device: torch.device) -> torch.Tensor:
    if rounds is None:
        rounds = full
    if isinstance(rounds, int):
        return torch.full((1,), rounds, dtype=torch.int32, device=device)
    if rounds.dtype != torch.int32 or rounds.numel() != 1 or rounds.device != device:
        raise ValueError("rounds must be an int or one int32 value on the kernel's device")
    return rounds.reshape(1).contiguous()


def nearest_class(valid: torch.Tensor, payload: torch.Tensor, cls_bits: int,
                  rounds=None) -> torch.Tensor:
    """valid [B, H, W] bool, payload [B, H, W] int32 (values < 2**cls_bits)
    -> [B, H, W] int32 payload of each pixel's nearest valid seed.

    ``rounds``: None (full chain), an int, or an int32 device scalar such as
    ``core.unwarp.jfa_rounds_from_grid``'s, which the kernel reads on the
    device. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check(valid, payload, cls_bits)
    if valid.device.type == "cpu":
        return nearest_class_plain(valid, payload, cls_bits, rounds)
    if valid.device.type != "cuda":
        raise ValueError(f"nearest_class runs on cpu or cuda tensors, not {valid.device}")
    b, h, w = valid.shape
    if h >= _MAX_SIDE or w >= _MAX_SIDE or b >= 65536:
        raise ValueError(f"canvas {b}x{h}x{w} exceeds the kernel's limits")
    if not (valid.is_contiguous() and payload.is_contiguous()):
        raise ValueError("nearest_class needs contiguous valid and payload")
    full = full_rounds(h, w)
    r = _rounds_tensor(rounds, full, valid.device)
    out = torch.empty((b, h, w), dtype=torch.int32, device=valid.device)
    scratch = torch.empty_like(out)
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(valid.data_ptr(), payload.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        r.data_ptr(), b, h, w, full, stream)
    if err != 0:
        raise RuntimeError(f"jfa kernel launch failed with CUDA error {err}")
    nearest_class.launches += 1
    return out


nearest_class.launches = 0


def _kernel():
    from fovealseg_torch.ops.build import load

    fn = load("jfa").fovealseg_jfa_nearest_class
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
