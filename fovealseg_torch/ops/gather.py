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

**Gradient (K5b).** A float32 table that requires grad, with gradients on,
goes through :class:`RowGather`: its forward is the gather above, its
backward ``row_gather_backward``, the scatter-add
``grad[b, idx[b, p], :] += grad_out[b, p, :]`` of the gradient rows into a
[B, T, C] table (the JAX package's autodiff of the flat gather). Its order
of summation is fixed: ``grad[b, r, c]`` is one chain of f32 adds from +0.0
over the pixels of row r in ascending pixel order, the order of the JAX
package's own gradient, so both versions are bit-equal to it and their bits
depend on the inputs alone. On a CUDA tensor the backward launches the
hand-written kernel (``csrc/gather.cu``: a counting sort of the pixels by
row with integer atomics, then one warp per non-empty row that sorts the
row's pixel ids and sums them in that order, and at C > 32 one block per
64 channels of each row of more than 256 pixels; no f32 atomics, no host
synchronisation, scratch from PyTorch's caching allocator); on a CPU tensor
it takes ``row_gather_backward_plain``, the same order in plain PyTorch.
Its launch count is ``row_gather_backward.launches``: one per call (the
call makes five kernel launches, six at C > 32). A CUDA table that requires grad never
loses its gradient: it takes the Function or raises.
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
    raise. A table that requires grad (gradients on) goes through
    :class:`RowGather`, so its gradient is K5b's scatter-add."""
    _check(values, idx)
    if values.requires_grad and torch.is_grad_enabled():
        if values.dtype != torch.float32:
            raise ValueError("row_gather's gradient needs a float32 table")
        return RowGather.apply(values, idx)
    return _gather(values, idx)


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (contiguous, or raise), False for CPU ones."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return True


def _limits(name: str, b: int, n: int) -> None:
    if b >= 65536 or n >= 2**31:
        raise ValueError(f"{name} of {b} x {n} rows exceeds the kernel's limits")


def _call(fn, dev: torch.device, *args) -> None:
    """Call a C entry point on ``dev``'s current stream; raise on its error."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed with CUDA error {err}")


def _gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather without autograd: the plain version on the CPU, K5 on the
    card."""
    if not _on_card("row_gather", values, idx):
        return row_gather_plain(values, idx)
    dev = values.device
    b, t, c = values.shape
    n = idx.numel() // b if b else 0
    _limits("row_gather", b, n)
    out = torch.empty((*idx.shape, c), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    ptrs = (values.data_ptr(), idx.data_ptr(), out.data_ptr())
    variant = gather_variant(c, n, *ptrs)
    _call(_kernel("fovealseg_row_gather"), dev, *ptrs, b, n, t, c, variant)
    row_gather.launches += 1
    return out


def row_gather_backward_plain(grad_out: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """Plain PyTorch version of K5b, in K5b's order of summation:
    grad_out [B, ..., C] float32, idx [B, ...] int32 -> [B, T, C], where
    ``grad[b, r, c]`` is the f32 sum, in ascending pixel order, of
    ``grad_out[b, p, c]`` over the pixels p with ``clamp(idx[b, p], 0, T-1)
    == r``, one chain of adds from +0.0 (rows no pixel reaches stay +0.0).

    A stable sort of the flat row indices groups each row's pixels in
    ascending order; step j then adds the j-th pixel of every row that has
    one, so each element takes its terms one at a time, in order."""
    b, c = idx.shape[0], grad_out.shape[-1]
    dev = grad_out.device
    off = torch.arange(b, dtype=torch.int64, device=dev).view(b, 1) * t
    flat = (idx.reshape(b, -1).to(torch.int64).clamp(0, t - 1) + off).reshape(-1)
    grad = torch.zeros((b * t, c), dtype=grad_out.dtype, device=dev)
    if flat.numel() == 0:
        return grad.reshape(b, t, c)
    rows, pix = torch.sort(flat, stable=True)
    counts = torch.bincount(rows, minlength=b * t)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.numel(), device=dev) - starts[rows]  # rank within the row
    by_pos = torch.sort(pos, stable=True).indices  # slab j: the j-th pixel of every row
    slab_ends = torch.cumsum(torch.bincount(pos), 0).tolist()
    rows, pix = rows[by_pos], pix[by_pos]
    values = grad_out.reshape(-1, c)
    lo = 0
    for hi in slab_ends:  # the rows of one slab are distinct: one f32 add per element
        r = rows[lo:hi]
        grad[r] = grad[r] + values[pix[lo:hi]]
        lo = hi
    return grad.reshape(b, t, c)


def row_gather_backward(grad_out: torch.Tensor, idx: torch.Tensor, t: int) -> torch.Tensor:
    """K5b: the gradient of ``row_gather`` with respect to its [B, T, C]
    table, ``grad[b, idx[b, p], :] += grad_out[b, p, :]`` (indices clamped to
    [0, T) as the forward clamps them). grad_out [B, ..., C] float32, idx
    [B, ...] int32. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    b = idx.shape[0]
    c = grad_out.shape[-1]
    if grad_out.dtype != torch.float32 or tuple(grad_out.shape[:-1]) != tuple(idx.shape):
        raise ValueError(f"grad_out must be float32 [*idx.shape, C], got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} for idx {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != grad_out.device:
        raise ValueError("idx must be int32 on grad_out's device")
    if t <= 0 or not 0 < c < 65536:
        raise ValueError(f"row_gather_backward needs rows and 1..65535 channels (T={t}, C={c})")
    if not _on_card("row_gather_backward", grad_out, idx):
        return row_gather_backward_plain(grad_out, idx, t)
    dev = grad_out.device
    n = idx.numel() // b if b else 0
    _limits("row_gather_backward", b, n)
    if n == 0 or b == 0:
        return torch.zeros((b, t, c), dtype=torch.float32, device=dev)
    grad = torch.empty((b, t, c), dtype=torch.float32, device=dev)  # K5b writes every word
    scratch = torch.empty(_kernel("fovealseg_row_gather_backward_scratch")(b, n, t),
                          dtype=torch.int32, device=dev)
    _call(_kernel("fovealseg_row_gather_backward"), dev, grad_out.data_ptr(), idx.data_ptr(),
          grad.data_ptr(), scratch.data_ptr(), scratch.numel(), b, n, t, c)
    row_gather_backward.launches += 1
    return grad


class RowGather(torch.autograd.Function):
    """``row_gather`` with a gradient for the table: forward K5 (or the plain
    gather on the CPU), backward K5b (or ``row_gather_backward_plain``)."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.rows = values.shape[1]
        return _gather(values, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return row_gather_backward(grad_out.contiguous(), idx, ctx.rows), None


row_gather.launches = 0
row_gather_backward.launches = 0
_ARGTYPES = {
    "fovealseg_row_gather": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p],
    "fovealseg_row_gather_backward": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                              ctypes.c_longlong, ctypes.c_int,
                                                              ctypes.c_int, ctypes.c_void_p],
    "fovealseg_row_gather_backward_scratch": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
}
_RESTYPES = {"fovealseg_row_gather_backward_scratch": ctypes.c_longlong}
_fns: dict = {}


def _kernel(name: str = "fovealseg_row_gather"):
    """A C entry point of ``csrc/gather.cu``, resolved once (built at first use)."""
    fn = _fns.get(name)
    if fn is None:
        from fovealseg_torch.ops.build import load

        fn = getattr(load("gather"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _fns[name] = fn
    return fn
