"""Row gather: ``out[b, ..., :] = values[b, idx[b, ...], :]`` (counterpart of
``fovealseg_tpu/ops/pallas_gather.py::windowed_row_gather``, K5, and of the
XLA flat gather ``core/unwarp.py::_gather_rows_flat``).

``row_gather`` launches the hand-written CUDA kernel
(``fovealseg_torch/csrc/gather.cu``) for CUDA tensors and takes the plain
PyTorch version, ``row_gather_plain``, for CPU tensors. The kernel copies
32-bit words, so it serves float32 and int32 tables and is bit-exact.
Indices outside [0, T) are clamped, in both versions.

The kernel's launch count is ``row_gather.launches``: one per call that
launched it.
"""

from __future__ import annotations

import ctypes

import torch

_WORD_DTYPES = (torch.float32, torch.int32)


def _check(values: torch.Tensor, idx: torch.Tensor) -> None:
    if values.dim() != 3 or values.dtype not in _WORD_DTYPES:
        raise ValueError(f"values must be [B, T, C] float32 or int32, "
                         f"got {tuple(values.shape)} {values.dtype}")
    if idx.dtype != torch.int32 or idx.dim() < 2 or idx.shape[0] != values.shape[0]:
        raise ValueError(f"idx must be [B, ...] int32 with B = {values.shape[0]}, "
                         f"got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != values.device:
        raise ValueError("values and idx must be on one device")
    if values.shape[1] == 0 or not 0 < values.shape[2] < 65536:
        raise ValueError(f"values must have rows and 1..65535 channels, got {tuple(values.shape)}")


def row_gather_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_select`` over the flattened
    [B*T, C] table. values [B, T, C]; idx [B, ...] int32 -> [B, ..., C]."""
    _check(values, idx)
    b, t, c = values.shape
    off = torch.arange(b, dtype=torch.int64, device=idx.device).view(b, 1) * t
    flat = idx.reshape(b, -1).to(torch.int64).clamp(0, t - 1) + off
    return values.reshape(b * t, c).index_select(0, flat.reshape(-1)).reshape(*idx.shape, c)


def row_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5. values [B, T, C] float32 or int32; idx [B, ...] int32 ->
    [B, ..., C] of ``values``' dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(values, idx)
    if values.device.type == "cpu":
        return row_gather_plain(values, idx)
    if values.device.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda tensors, not {values.device}")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather needs contiguous values and idx")
    b, t, c = values.shape
    n = idx[0].numel()
    if b >= 65536 or b * n >= 2**31 * 256:
        raise ValueError(f"row_gather of {b} x {n} rows exceeds the kernel's limits")
    out = torch.empty((*idx.shape, c), dtype=values.dtype, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(values.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, t, c, stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed with CUDA error {err}")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def _kernel():
    from fovealseg_torch.ops.build import load

    fn = load("gather").fovealseg_row_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
