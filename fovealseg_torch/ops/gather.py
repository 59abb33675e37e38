"""Row gather: ``out[b, ..., :] = values[b, idx[b, ...], :]`` (counterpart of
``fovealseg_tpu/ops/pallas_gather.py::windowed_row_gather``, K5, and of the
XLA flat gather ``core/unwarp.py::_gather_rows_flat``).

``row_gather`` launches the hand-written CUDA kernel
(``fovealseg_torch/csrc/gather.cu``) for CUDA tensors and takes the plain
PyTorch version, ``row_gather_plain``, for CPU tensors. The kernel copies
32-bit words, so it serves float32 and int32 tables and is bit-exact.
Indices outside [0, T) are clamped, in both versions. Which of the kernel's
three variants runs is decided here, by :func:`gather_variant`, from the
channel count and the alignment of the three tensors.

The wrapper's host work per call is kept small, because at C <= 3 the
kernel takes ~10-40 us: the C function is resolved once, and the device
context is entered only when the tensors are not on the current device.

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


VARIANT_SCALAR, VARIANT_SMALL, VARIANT_WIDE = 0, 1, 2
VARIANT_NAMES = ("scalar", "small", "wide")
SMALL_MAX_C = 4


def gather_variant(c: int, n: int, table_ptr: int, idx_ptr: int, out_ptr: int) -> int:
    """The kernel variant for ``c`` channels, ``n`` indices per image and the
    three base addresses (mirrored by ``choose_variant`` in
    ``csrc/gather.cu``, which refuses any other choice but the scalar one):

    * ``VARIANT_SMALL`` for c <= 4: 4 pixels per thread, one 16-byte index
      load, row-vector table loads, 16-byte stores. Needs n % 4 == 0,
      16-byte aligned indices and output, and a table aligned to its row
      vector (8 bytes at c = 2, 16 at c = 4);
    * ``VARIANT_WIDE`` for c > 4: 16-byte streaming stores over each block's
      span of output words. Needs n * c % 4 == 0 and a 16-byte aligned
      output;
    * ``VARIANT_SCALAR`` otherwise: word by word."""
    if c <= SMALL_MAX_C:
        row_align = 4 * c if c in (2, 4) else 4
        if n % 4 == 0 and idx_ptr % 16 == 0 and out_ptr % 16 == 0 and table_ptr % row_align == 0:
            return VARIANT_SMALL
    elif n * c % 4 == 0 and out_ptr % 16 == 0:
        return VARIANT_WIDE
    return VARIANT_SCALAR


def row_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5. values [B, T, C] float32 or int32; idx [B, ...] int32 ->
    [B, ..., C] of ``values``' dtype. CPU tensors take the plain version;
    CUDA tensors launch the kernel, in :func:`gather_variant`'s variant, or
    raise."""
    _check(values, idx)
    dev = values.device
    if dev.type == "cpu":
        return row_gather_plain(values, idx)
    if dev.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda tensors, not {dev}")
    if not (values.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather needs contiguous values and idx")
    b, t, c = values.shape
    n = idx.numel() // b if b else 0
    if b >= 65536 or n >= 2**31:
        raise ValueError(f"row_gather of {b} x {n} rows exceeds the kernel's limits")
    out = torch.empty((*idx.shape, c), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    ptrs = (values.data_ptr(), idx.data_ptr(), out.data_ptr())
    variant = gather_variant(c, n, *ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = _kernel()(*ptrs, b, n, t, c, variant, stream)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*ptrs, b, n, t, c, variant, stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed with CUDA error {err}")
    row_gather.launches += 1
    return out


row_gather.launches = 0
_fn = None


def _kernel():
    """The C entry point, resolved once (built at first use)."""
    global _fn
    if _fn is None:
        from fovealseg_torch.ops.build import load

        fn = load("gather").fovealseg_row_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn
