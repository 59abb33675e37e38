"""Torch-semantics image resizing on NHWC tensors (counterpart of
``fovealseg_tpu/core/interpolate.py``).

As in the JAX package, each axis of a bilinear resize is a dense
``[out, in]`` matrix contraction, run in full f32 (no TF32, see
:func:`full_f32_matmul`) whatever the input's dtype, and cast back.
``F.interpolate(mode='bilinear', align_corners=False)`` computes the same
function but rounds its source coordinates in f32, which moves
non-integer-ratio resizes by up to ~2e-5.
"""

from __future__ import annotations

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


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The [out, in] resize matrix as an f32 tensor on ``device``."""
    return torch.from_numpy(_linear_resize_matrix(in_size, out_size)).to(device)


def _resize(x: torch.Tensor, out_hw: tuple[int, int], h_axis: int) -> torch.Tensor:
    """Resize the axes ``h_axis`` and ``h_axis + 1`` of ``x`` to ``out_hw``."""
    if tuple(x.shape[h_axis:h_axis + 2]) == tuple(out_hw):
        return x
    y = x.to(torch.float32)
    with full_f32_matmul():
        for axis, out_size in ((h_axis, out_hw[0]), (h_axis + 1, out_hw[1])):
            if y.shape[axis] == out_size:
                continue
            m = _resize_matrix(y.shape[axis], out_size, y.device)
            if axis == y.dim() - 1:
                y = torch.matmul(y, m.t())
            else:
                y = torch.matmul(m, y.movedim(axis, -2)).movedim(-2, axis)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Torch ``F.interpolate(mode='bilinear', align_corners=False)``. NHWC."""
    return _resize(x, out_hw, 1)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The same resize on an NCHW tensor."""
    return _resize(x, out_hw, 2)
