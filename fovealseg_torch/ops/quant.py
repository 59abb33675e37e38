"""W8A8 int8 convolution for ``TPU.quantize="int8"`` serving (counterpart of
``fovealseg_tpu/models/layers.py::_int8_conv``, which the JAX package leaves
to XLA; no Pallas kernel).

=================  ==================================================  ====
wrapper            what it computes                                    #
=================  ==================================================  ====
``absmax_scale``   ``s_x = max(max |x|, 1e-12) / 127`` (f32 scalar)    K6
``quantize_act``   ``int8(rint(x / s_x))``, NCHW in, NHWC codes out    K7
``int8_conv2d``    the int32 conv of the codes, ``* (s_x * s_w)``,     K8
                   cast, ``+ bias``; NCHW out
=================  ==================================================  ====

Symmetric, zero-point 0: the weights carry a per-output-channel scale
``s_w`` (``models/layers.py::quantize_kernel``, made once when the model is
quantized), the activation one dynamic scale for the whole tensor (the
micro-batch). :func:`w8a8_conv2d`, what every quantized conv calls, is the
one registered operator, ``torch.ops.fovealseg.w8a8_conv2d``
(``ops/library.py``): its CUDA kernel makes one host call that launches K6,
K7 and K8 in turn (``fovealseg_torch/csrc/quant.cu``), its CPU kernel chains
the three wrappers. Each wrapper runs its kernel on a CUDA tensor and its
plain PyTorch version (``*_plain``) on a CPU one, which is how tests and
measurements hold one kernel at a time; a CUDA tensor launches or raises.

The plain conv takes the int8 codes to float64 and calls ``F.conv2d``: each
product and partial sum is an integer below 2^53 (at most 127^2 * 9 * 960
~ 1.4e8 in the served models), so it returns the int32 sums exactly, in any
order of summation, as the kernel's int32 accumulators do. The epilogue then
runs as separate ops in the JAX package's order: int32 -> f32, times the
product ``s_x * s_w`` (taken first), cast to the output dtype, plus the bias
in the output dtype. The kernel does the same with round-to-nearest
intrinsics, so both are bit-equal.

Shapes the kernel takes (the served models' quantized convs): kernel 1 or 3,
square; stride 1, 2 or 4 (C1's class head strides by 4); padding 0 or 1;
input channels a multiple of 16; f32 or bf16. Anything else raises.

Counts: ``<wrapper>.launches``, one per launch of that kernel, by the
wrapper or by :func:`w8a8_conv2d`'s CUDA kernel (which launches all three);
``<wrapper>.plain_calls``, one per call of the wrapper on CPU tensors (a
direct call of ``*_plain`` counts in neither).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fovealseg_torch.ops.gather import _call, _on_card
from fovealseg_torch.ops.library import register

_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_SIZES, STRIDES, PADDINGS = (1, 3), (1, 2, 4), (0, 1)
CHANNEL_MULTIPLE = 16


def _check_act(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty [B, C, H, W] float32 or bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")


def _check_scale(name: str, s_x: torch.Tensor, x: torch.Tensor) -> None:
    if s_x.dtype != torch.float32 or s_x.numel() != 1 or s_x.device != x.device:
        raise ValueError(f"{name}: s_x must be one float32 value on {x.device}")


# ------------------------------------------------------------------ K6


def absmax_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """``max(max |x|, 1e-12) / 127`` in f32, a 0-d tensor on x's device. The
    divisor is a tensor on that device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not the IEEE quotient."""
    m = torch.clamp_min(x.float().abs().amax(), 1e-12)
    return m / torch.full((), 127.0, device=m.device)


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """K6: the activation scale of ``x`` [B, C, H, W] (f32 or bf16) over the
    whole tensor, a 0-d f32 tensor on x's device (no host synchronisation)."""
    _check_act("absmax_scale", x)
    if not _on_card("absmax_scale", x):
        absmax_scale.plain_calls += 1
        return absmax_scale_plain(x)
    dev, n = x.device, x.numel()
    partial = torch.empty(_kernel("fovealseg_absmax_partials")(n), dtype=torch.float32,
                          device=dev)
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    _call(_kernel("fovealseg_absmax_scale"), dev, x.data_ptr(), n,
          int(x.dtype == torch.bfloat16), partial.data_ptr(), s_x.data_ptr())
    absmax_scale.launches += 1
    return s_x


# ------------------------------------------------------------------ K7


def quantize_act_plain(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``int8(round_half_even(x / s_x))`` of x [B, C, H, W], as [B, H, W, C]."""
    return torch.round(x.float() / s_x).to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _quantize_limits(name: str, b: int, c: int) -> None:
    if c % 4:
        raise ValueError(f"{name}: channels must be a multiple of 4, got {c}")
    if b >= 65536 or -(-c // 32) >= 65536:
        raise ValueError(f"{name}: batch {b} x {c} channels exceeds the kernel's limits")


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """K7: the int8 codes of x [B, C, H, W] (f32 or bf16) at scale ``s_x``,
    channels innermost ([B, H, W, C], the layout ``int8_conv2d`` reads)."""
    _check_act("quantize_act", x)
    _check_scale("quantize_act", s_x, x)
    b, c, h, w = x.shape
    _quantize_limits("quantize_act", b, c)
    if not _on_card("quantize_act", x, s_x):
        quantize_act.plain_calls += 1
        return quantize_act_plain(x, s_x.reshape(()))
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    _call(_kernel("fovealseg_quantize_act"), x.device, x.data_ptr(), s_x.data_ptr(),
          q.data_ptr(), b, c, h * w, int(x.dtype == torch.bfloat16))
    quantize_act.launches += 1
    return q


# ------------------------------------------------------------------ K8


def _out_hw(h: int, w: int, k: int, stride: int, padding: int) -> tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def _check_conv(name, b, h, w, c, device, weight_q, w_scale, bias, stride, padding,
                dtype) -> None:
    """The conv of a [b, c, h, w] activation on ``device`` with weight codes
    [N, k, k, c], as K8 takes it (and its ``b * ho * wo``, N limits)."""
    if weight_q.dim() != 4 or weight_q.dtype != torch.int8 or weight_q.shape[3] != c:
        raise ValueError(f"{name}: weight_q must be [N, k, k, {c}] int8, "
                         f"got {tuple(weight_q.shape)} {weight_q.dtype}")
    n, kh, kw = weight_q.shape[:3]
    if kh != kw or kh not in KERNEL_SIZES or stride not in STRIDES or padding not in PADDINGS:
        raise ValueError(f"{name} takes kernels {KERNEL_SIZES}, strides {STRIDES} and "
                         f"paddings {PADDINGS}, got {kh}x{kw}, stride {stride}, "
                         f"padding {padding}")
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"{name}: input channels must be a multiple of {CHANNEL_MULTIPLE}, "
                         f"got {c}")
    ho, wo = _out_hw(h, w, kh, stride, padding)
    if min(ho, wo) <= 0:
        raise ValueError(f"{name}: a {kh}x{kw} kernel does not fit {h}x{w}")
    if b * ho * wo >= 2**31 or b * h * w >= 2**31 or max(h, w) >= 2**15 - 1 or \
            -(-n // 128) >= 65536:
        raise ValueError(f"{name} of {(b, c, h, w)} x {tuple(weight_q.shape)} exceeds the "
                         f"kernel's limits")
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: output dtype must be float32 or bfloat16, got {dtype}")
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (n,):
        raise ValueError(f"{name}: w_scale must be float32 [{n}]")
    if bias is not None and (bias.dtype != dtype or tuple(bias.shape) != (n,)):
        raise ValueError(f"{name}: bias must be {dtype} [{n}] or None")
    if any(t.device != device for t in (weight_q, w_scale) + ((bias,) if bias is not None
                                                              else ())):
        raise ValueError(f"{name}: every tensor must be on one device")


def int8_sums_plain(xq: torch.Tensor, weight_q: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """The exact int32 sums of the conv of codes xq [B, H, W, C] with
    weight_q [N, k, k, C], as [B, N, Ho, Wo] (float64 products and sums of
    integers below 2^53)."""
    z = F.conv2d(xq.permute(0, 3, 1, 2).double(), weight_q.permute(0, 3, 1, 2).double(),
                 stride=stride, padding=padding)
    return z.to(torch.int32).contiguous()  # NCHW, as K8 writes it


def dequantize_plain(z: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The epilogue of int32 sums z [B, N, Ho, Wo]: ``f32(z) * (s_x * s_w)``,
    cast to ``dtype``, plus the bias in ``dtype``."""
    y = (z.float() * (s_x * w_scale).view(1, -1, 1, 1)).to(dtype)
    return y if bias is None else y + bias.to(dtype).view(1, -1, 1, 1)


def int8_conv2d_plain(xq, weight_q, s_x, w_scale, bias, stride: int, padding: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K8: :func:`int8_sums_plain`, then
    :func:`dequantize_plain`."""
    return dequantize_plain(int8_sums_plain(xq, weight_q, stride, padding), s_x, w_scale, bias,
                            dtype)


def int8_conv2d(xq: torch.Tensor, weight_q: torch.Tensor, s_x: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor | None, stride: int, padding: int,
                dtype: torch.dtype) -> torch.Tensor:
    """K8: the W8A8 conv of codes xq [B, H, W, C] (``quantize_act``'s) with
    weight codes [N, k, k, C] and scales ``w_scale`` [N], ``bias`` [N] in
    ``dtype`` or None -> [B, N, Ho, Wo] of ``dtype`` (f32 or bf16)."""
    if xq.dim() != 4 or xq.dtype != torch.int8 or xq.numel() == 0:
        raise ValueError(f"int8_conv2d: xq must be non-empty [B, H, W, C] int8, "
                         f"got {tuple(xq.shape)} {xq.dtype}")
    b, h, w, c = xq.shape
    _check_conv("int8_conv2d", b, h, w, c, xq.device, weight_q, w_scale, bias, stride, padding,
                dtype)
    _check_scale("int8_conv2d", s_x, xq)
    tensors = (xq, weight_q, s_x, w_scale) + ((bias,) if bias is not None else ())
    if not _on_card("int8_conv2d", *tensors):
        int8_conv2d.plain_calls += 1
        return int8_conv2d_plain(xq, weight_q, s_x.reshape(()), w_scale, bias, stride, padding,
                                 dtype)
    if xq.data_ptr() % 16 or weight_q.data_ptr() % 16:
        raise ValueError("int8_conv2d: the codes must be 16-byte aligned")
    n, k = weight_q.shape[:2]
    out = torch.empty((b, n, *_out_hw(h, w, k, stride, padding)), dtype=dtype, device=xq.device)
    _call(_kernel("fovealseg_int8_conv2d"), xq.device, xq.data_ptr(), weight_q.data_ptr(),
          s_x.data_ptr(), w_scale.data_ptr(), bias.data_ptr() if bias is not None else None,
          out.data_ptr(), b, h, w, c, n, k, k, stride, padding, int(dtype == torch.bfloat16))
    int8_conv2d.launches += 1
    return out


def int8_conv_plan(m: int, n: int, k: int) -> dict:
    """K8's planner (``csrc/quant.cu::plan_conv``) for an M x N x K conv
    (M = B*Ho*Wo, K = kh*kw*C): its tile width, tiles, 128-byte K steps
    and split of K. Builds the library (nvcc), needs no card."""
    plan = (ctypes.c_int * 6)()
    _kernel("fovealseg_int8_conv_plan")(m, n, k, plan)
    return dict(zip(("bn", "m_tiles", "n_tiles", "steps", "splits", "steps_per_split"), plan))


# ------------------------------------------------------------ K6 -> K7 -> K8


def w8a8_conv2d(x: torch.Tensor, weight_q: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None, stride: int, padding: int) -> torch.Tensor:
    """The W8A8 conv of x [B, C, H, W] in its own dtype (f32 or bf16): K6,
    K7, K8, through the operator ``fovealseg::w8a8_conv2d``. ``bias`` in x's
    dtype or None. Inference only (no gradient)."""
    x = x.contiguous()
    _check_act("w8a8_conv2d", x)
    b, c, h, w = x.shape
    _quantize_limits("w8a8_conv2d", b, c)
    _check_conv("w8a8_conv2d", b, h, w, c, x.device, weight_q, w_scale, bias, stride, padding,
                x.dtype)
    return _w8a8_conv2d_op(x, weight_q, w_scale, bias, stride, padding)


def _w8a8_conv2d_cpu(x, weight_q, w_scale, bias, stride, padding):
    s_x = absmax_scale(x)
    return int8_conv2d(quantize_act(x, s_x), weight_q, s_x, w_scale, bias, stride, padding,
                       x.dtype)


@functools.lru_cache(maxsize=256)
def _workspace_bytes(n: int) -> int:
    return _kernel("fovealseg_w8a8_workspace_bytes")(n)


def _w8a8_conv2d_cuda(x, weight_q, w_scale, bias, stride, padding):
    _on_card("w8a8_conv2d", x, weight_q, w_scale, *((bias,) if bias is not None else ()))
    if weight_q.data_ptr() % 16:
        raise ValueError("w8a8_conv2d: the weight codes must be 16-byte aligned")
    b, c, h, w = x.shape
    n, k = weight_q.shape[:2]
    out = torch.empty((b, n, *_out_hw(h, w, k, stride, padding)), dtype=x.dtype, device=x.device)
    workspace = torch.empty(_workspace_bytes(x.numel()), dtype=torch.int8, device=x.device)
    _call(_kernel("fovealseg_w8a8_conv2d"), x.device, x.data_ptr(),
          int(x.dtype == torch.bfloat16), weight_q.data_ptr(), w_scale.data_ptr(),
          bias.data_ptr() if bias is not None else None, workspace.data_ptr(), out.data_ptr(),
          b, h, w, c, n, k, stride, padding)
    for fn in (absmax_scale, quantize_act, int8_conv2d):  # the call launched all three
        fn.launches += 1
    return out


def _w8a8_conv2d_fake(x, weight_q, w_scale, bias, stride, padding):
    ho, wo = _out_hw(x.shape[2], x.shape[3], weight_q.shape[1], stride, padding)
    return x.new_empty((x.shape[0], weight_q.shape[0], ho, wo))


_w8a8_conv2d_op = register(
    "w8a8_conv2d(Tensor x, Tensor weight_q, Tensor w_scale, Tensor? bias, int stride, "
    "int padding) -> Tensor", _w8a8_conv2d_cpu, _w8a8_conv2d_cuda, _w8a8_conv2d_fake)


for _fn in (absmax_scale, quantize_act, int8_conv2d):
    _fn.launches = 0
    _fn.plain_calls = 0

_ARGTYPES = {
    "fovealseg_absmax_partials": ([ctypes.c_longlong], ctypes.c_int),
    "fovealseg_absmax_scale": ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "fovealseg_quantize_act": ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_void_p], ctypes.c_int),
    "fovealseg_int8_conv_plan": ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)], None),
    "fovealseg_int8_conv2d": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
                              ctypes.c_int),
    "fovealseg_w8a8_workspace_bytes": ([ctypes.c_longlong], ctypes.c_longlong),
    "fovealseg_w8a8_conv2d": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int),
}
_fns: dict = {}


def _kernel(name: str):
    """A C entry point of ``csrc/quant.cu``, resolved once (built at first use)."""
    fn = _fns.get(name)
    if fn is None:
        from fovealseg_torch.ops.build import load

        fn = getattr(load("quant"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name]
        _fns[name] = fn
    return fn
