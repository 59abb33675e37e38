"""Torch-semantics image resizing on NHWC tensors (counterpart of
``fovealseg_tpu/core/interpolate.py``).

As in the JAX package, each axis of a bilinear resize is a dense
``[out, in]`` matrix contraction, run in full f32 (no TF32, see
:func:`full_f32_matmul`). A float32 input is contracted along H, then W, and
rounded once. Any other dtype (bfloat16) is rounded where the JAX package
rounds it: the matrix is cast to the input's dtype, and the result is
rounded back to that dtype after each axis.
``F.interpolate(mode='bilinear', align_corners=False)`` computes the same
function but rounds its source coordinates in f32, which moves
non-integer-ratio resizes by up to ~2e-5. ``resize_nearest`` is an index
gather per axis, with the source index ``floor(i * in / out)``.
``resize_area`` (adaptive average pooling, torch's ``mode='area'``) is the
same dense contraction with the pooling bins as the matrix.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] matrix for 1-D torch-bilinear resize."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


@functools.lru_cache(maxsize=128)
def _area_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] matrix for 1-D adaptive average pooling."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


_MATRICES = {"linear": _linear_resize_matrix, "area": _area_resize_matrix}


@functools.lru_cache(maxsize=128)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output position of a torch-nearest resize."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int32)
    return np.minimum(idx, in_size - 1)


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matrix products in full f32 (no TF32) inside the block and
    restore the caller's setting after it. The setting is process-wide, as
    PyTorch keeps it. Uses PyTorch's ``fp32_precision`` API: reading the
    legacy ``allow_tf32`` flag raises once a caller has set the new one."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def eager_cache(maxsize: int):
    """A least-recently-used cache (positional arguments) for functions that
    make tensors, which a trace (``torch.export``, ``torch.compile``) reads
    but never fills: a hit gives the cached device tensor, which becomes a
    constant of the program; a miss makes the tensor inside the trace and
    keeps nothing, since a traced tensor kept here would break the next
    eager call. ``cli/export.py`` warms the caches with one eager call
    before it traces, so that no constant of its program is copied from the
    host on every call."""
    def wrap(fn):
        store: collections.OrderedDict = collections.OrderedDict()

        @functools.wraps(fn)
        def call(*args):
            hit = store.get(args)
            if hit is not None:
                store.move_to_end(args)
                return hit
            value = fn(*args)
            if not torch.compiler.is_compiling():
                store[args] = value
                if len(store) > maxsize:
                    store.popitem(last=False)
            return value

        call.cache_clear = store.clear
        return call

    return wrap


@eager_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, device: torch.device,
                   dtype: torch.dtype = torch.float32, kind: str = "linear") -> torch.Tensor:
    """The [out, in] resize matrix of ``kind`` ('linear' or 'area') as an f32
    tensor on ``device``, its entries rounded to ``dtype``."""
    m = torch.from_numpy(_MATRICES[kind](in_size, out_size))
    return m.to(dtype).to(torch.float32).to(device)


def _resize(x: torch.Tensor, out_hw: tuple[int, int], h_axis: int,
            kind: str = "linear") -> torch.Tensor:
    """Resize the axes ``h_axis`` and ``h_axis + 1`` of ``x`` to ``out_hw``
    with ``kind``'s matrices."""
    if tuple(x.shape[h_axis:h_axis + 2]) == tuple(out_hw):
        return x
    per_axis = x.dtype != torch.float32
    y = x
    with full_f32_matmul():
        for axis, out_size in ((h_axis, out_hw[0]), (h_axis + 1, out_hw[1])):
            if y.shape[axis] == out_size:
                continue
            m = _resize_matrix(y.shape[axis], out_size, y.device, x.dtype, kind)
            y = y.to(torch.float32)
            if axis == y.dim() - 1:
                y = torch.matmul(y, m.t())
            else:
                y = torch.matmul(m, y.movedim(axis, -2)).movedim(-2, axis)
            if per_axis:
                y = y.to(x.dtype)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Torch ``F.interpolate(mode='bilinear', align_corners=False)``. NHWC."""
    return _resize(x, out_hw, 1)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The same resize on an NCHW tensor."""
    return _resize(x, out_hw, 2)


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Torch ``F.interpolate(mode='area')`` (adaptive average pooling). NHWC."""
    return _resize(x, out_hw, 1, "area")


def resize_area_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The same adaptive average pooling on an NCHW tensor."""
    return _resize(x, out_hw, 2, "area")


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Torch ``F.interpolate(mode='nearest')``. NHWC."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if h != oh:
        idx = torch.from_numpy(_nearest_index(h, oh)).to(x.device, torch.int64)
        x = torch.index_select(x, x.dim() - 3, idx)
    if w != ow:
        idx = torch.from_numpy(_nearest_index(w, ow)).to(x.device, torch.int64)
        x = torch.index_select(x, x.dim() - 2, idx)
    return x


def resize_1d(v: torch.Tensor, out_size: int) -> torch.Tensor:
    """Torch-bilinear resize of a 1-D vector (the Gaussian kernel's
    aspect-ratio stretch), one full-f32 product with the dense matrix."""
    m = _resize_matrix(v.shape[-1], out_size, v.device).to(v.dtype)
    with full_f32_matmul():
        return torch.matmul(m, v)
