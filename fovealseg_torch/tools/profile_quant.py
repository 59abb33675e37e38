"""The W8A8 int8 convolution (K8) at every quantized conv shape of one
flagship call, beside its bound and two library yardsticks.

Builds the flagship (HRNetV2-nodownsp + C1, 640x640 canvas -> 80x80 task, 51
classes, random weights from a seed) in float32 and bfloat16, quantizes it
(``models/layers.py::quantize_model``, what ``TPU.quantize int8`` runs),
serves one b8 batch of each and records, by forward hooks on the quantized
convs (:func:`w8a8_inputs`), each distinct conv's input and how many convs
of that shape one call runs. At each distinct shape and dtype it takes K6's
scale and K7's codes of the recorded input, holds K8 (``ops/quant.py::
int8_conv2d``) bit-equal to its plain version on the card, and prints:

* ``events_ms``: CUDA events around one call, median of ``--n``;
* ``loop_ms``: CUDA events around ``--n`` back-to-back calls, over ``--n``;
* ``device_ms``: the call's kernel time under ``torch.profiler``;
* ``bound_ms``: the larger of ``2*M*N*K`` over 1,979 TOPS (dense int8) and
  the bytes (codes, weight codes, scales and the output once each) over
  3.35 TB/s, and which of the two it is;
* yardsticks the port never calls: cuDNN's bf16 conv of the same shape
  (``F.conv2d``) and ``torch._int_mm`` of the codes' ``F.unfold`` (the
  product alone), in events and device ms.

Then the per-call sums weighted by the counts (K8's device ms, its bound,
the yardsticks'), and the card's name and power limit.

``--parent SRC`` also builds an earlier tree's ``csrc/quant.cu`` (unpacked
with ``git archive`` into a directory git ignores) with this tree's nvcc
flags and times its K8, held bit-equal too, in turns with this tree's
(earlier, this, this, earlier) in one process. The earlier entry point
``fovealseg_int8_conv2d`` takes what this tree's takes: six pointers, ten
ints, the stream. Usage, on a machine with the card:

    python -m fovealseg_torch.tools.profile_quant [--n 20]
        [--parent build/parent/fovealseg_torch/csrc/quant.cu]
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
import torch.nn.functional as F

from fovealseg_torch.tools.profile_gather import card_line, device_ms, events_ms, loop_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8, data sheet
SEED = 304


class RecordedConvs(dict):
    """What :func:`w8a8_inputs` records: the dict of inputs, and ``counts``,
    {key: calls of the convs of that key}."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}


@contextlib.contextmanager
def w8a8_inputs(models, keep_all: bool = False):
    """The inputs of each quantized conv's call (``Conv2d`` holding
    ``weight_q``, which calls ``ops/quant.py::w8a8_conv2d``) in ``models``,
    recorded by forward hooks. Yields a :class:`RecordedConvs`: by default
    {(x shape, dtype, weight shape, stride, padding, has bias): (x,
    weight_q, w_scale, bias, stride, padding)}, one entry per distinct
    shape; with ``keep_all``, {i: (those inputs, the conv's output)} for
    every call."""
    seen = RecordedConvs()

    def record(m, args, out):
        x = args[0].to(m.compute_dtype)
        bias = m._cast_param("bias", m.bias)
        key = (tuple(x.shape), x.dtype, tuple(m.weight_q.shape), m.stride[0], m.padding[0],
               bias is not None)
        seen.counts[key] = seen.counts.get(key, 0) + 1
        if keep_all or key not in seen:
            conv = (x.detach().clone(memory_format=torch.contiguous_format), m.weight_q,
                    m.w_scale, bias, m.stride[0], m.padding[0])
            seen[len(seen) if keep_all else key] = (conv, out.clone()) if keep_all else conv

    hooks = [m.register_forward_hook(record) for model in models for m in model.modules()
             if "weight_q" in m._buffers]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def flagship_convs(device, batch: int = 8) -> dict:
    """{dtype name: the distinct quantized convs' inputs of one b``batch``
    call of the quantized flagship (``w8a8_inputs``, with its counts)}."""
    import numpy as np

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights, quantize_model

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 640, 640, 3)).astype(np.float32)).to(device)
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32)).to(device)
    cfg = DeformConfig(task_hw=(80, 80), task_hw_infer=(80, 80), saliency_hw=(80, 80),
                       gaussian_radius=45, num_class=51, arch_encoder="hrnetv2_nodownsp")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = init_weights(DeformSegmentation(cfg, dtype=dtype, device=device),
                             torch.Generator().manual_seed(SEED))
        quantize_model(model)
        with torch.no_grad(), w8a8_inputs([model]) as seen:
            model.infer(x, f, argmax_labels=True)
        out[str(dtype).replace("torch.", "")] = seen
        del model
    return out


def conv_geometry(x, weight_q, stride: int, padding: int) -> dict:
    b, c, h, w = x.shape
    n, k = weight_q.shape[:2]
    ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    return {"b": b, "c": c, "h": h, "w": w, "n": n, "k": k, "stride": stride,
            "padding": padding, "ho": ho, "wo": wo, "m": b * ho * wo, "kdim": k * k * c}


def k8_bound(g: dict, out_bytes: int) -> tuple[float, str]:
    """K8's least time in ms: operations over the int8 rate or bytes (codes,
    weight codes, scales, bias, output, once each) over the memory rate."""
    ops = 2 * g["m"] * g["n"] * g["kdim"]
    moved = (g["b"] * g["c"] * g["h"] * g["w"] + g["n"] * g["kdim"] + 8 * g["n"] + 4
             + g["m"] * g["n"] * out_bytes)
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def parent_k8(source: str):
    """``fn(xq, weight_q, s_x, w_scale, bias, stride, padding, dtype)``: K8 of
    an earlier tree's ``csrc/quant.cu``, compiled with this tree's flags
    into ``build/kernels``."""
    import ctypes
    import hashlib
    import os
    import subprocess

    from fovealseg_torch.ops import build

    src = open(source, "rb").read()
    lib = build.BUILD_DIR / f"libparent_quant-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp), source], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).fovealseg_int8_conv2d
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(xq, weight_q, s_x, w_scale, bias, stride, padding, dtype):
        b, h, w, c = xq.shape
        n, k = weight_q.shape[:2]
        ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
        out = torch.empty((b, n, ho, wo), dtype=dtype, device=xq.device)
        err = fn(xq.data_ptr(), weight_q.data_ptr(), s_x.data_ptr(), w_scale.data_ptr(),
                 bias.data_ptr() if bias is not None else None, out.data_ptr(), b, h, w, c, n,
                 k, k, stride, padding, int(dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier K8 failed to launch with CUDA error {err}")
        return out

    return run


def timed(fn, n: int) -> dict:
    dev, per_call, _ = device_ms(fn, n)
    return {"events_ms": events_ms(fn, n), "loop_ms": loop_ms(fn, n),
            "device_ms": dev if per_call else None}


def measure(args_conv, n: int, parent=None) -> dict:
    """K8 (and the earlier K8) at one recorded conv: bit-equal to the plain
    version, timed, beside the bound and the yardsticks."""
    from fovealseg_torch.ops import quant

    x, weight_q, w_scale, bias, stride, padding = args_conv
    g = conv_geometry(x, weight_q, stride, padding)
    s_x = quant.absmax_scale(x)
    xq = quant.quantize_act(x, s_x)
    ref = quant.int8_conv2d_plain(xq, weight_q, s_x, w_scale, bias, stride, padding, x.dtype)
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    runs = {"k8": lambda: quant.int8_conv2d(xq, weight_q, s_x, w_scale, bias, stride, padding,
                                            x.dtype)}
    if parent is not None:
        runs["parent_k8"] = lambda: parent(xq, weight_q, s_x, w_scale, bias, stride, padding,
                                           x.dtype)
    for name, fn in runs.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not (torch.equal(first.view(bits), ref.view(bits))
                and torch.equal(second.view(bits), ref.view(bits))):
            raise AssertionError(f"{name} != int8_conv2d_plain at {g}")
    del first, second, ref
    bound, bound_by = k8_bound(g, x.element_size())
    res = {**g, "dtype": str(x.dtype).replace("torch.", ""), "bias": bias is not None,
           "plan": quant.int8_conv_plan(g["m"], g["n"], g["kdim"]),
           "bound_ms": bound, "bound_by": bound_by, "gop": 2 * g["m"] * g["n"] * g["kdim"] / 1e9}
    if parent is None:
        res["k8"] = timed(runs["k8"], n)
    else:  # in turns: earlier, this, this, earlier
        first_parent = timed(runs["parent_k8"], n)
        res["k8"] = timed(runs["k8"], n)
        res["k8_again"] = timed(runs["k8"], n)
        res["parent_k8"] = first_parent
        res["parent_k8_again"] = timed(runs["parent_k8"], n)
    xb = x.to(torch.bfloat16)
    wb = weight_q.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
    codes_nchw = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    cols = F.unfold(codes_nchw, g["k"], padding=padding, stride=stride).to(torch.int8)
    a = cols.transpose(1, 2).reshape(g["m"], g["kdim"]).contiguous()
    bmat = weight_q.permute(0, 3, 1, 2).reshape(g["n"], -1).t().contiguous()
    del cols, codes_nchw
    yardsticks = {"cudnn_bf16_conv": lambda: F.conv2d(xb, wb, stride=stride, padding=padding),
                  "int_mm": lambda: torch._int_mm(a, bmat)}
    for name, fn in yardsticks.items():
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:  # a yardstick the installed PyTorch does not run
            res[name] = {"error": str(e).splitlines()[0]}
            continue
        res[name] = timed(fn, n)
    return res


def _mean_device(res: dict, *names) -> float | None:
    reads = [res[k]["device_ms"] for k in names if k in res and res[k].get("device_ms")]
    return sum(reads) / len(reads) if reads else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20, help="calls per timing")
    ap.add_argument("--parent", metavar="SRC",
                    help="an earlier tree's csrc/quant.cu whose K8 to time beside this one")
    args = ap.parse_args(argv)

    from fovealseg_torch import resolve_device

    device = resolve_device("cuda")
    print("card:", card_line(), flush=True)
    parent = parent_k8(args.parent) if args.parent else None
    convs = flagship_convs(device)
    totals = {}
    for dtype, seen in convs.items():
        sums = dict.fromkeys(("k8", "parent_k8", "bound", "cudnn_bf16_conv", "int_mm"), 0.0)
        unread = set()
        for key, conv in seen.items():
            count = seen.counts[key]
            res = measure(conv, args.n, parent)
            res["convs_per_call"] = count
            print(json.dumps(res), flush=True)
            reads = {"k8": _mean_device(res, "k8", "k8_again"),
                     "parent_k8": _mean_device(res, "parent_k8", "parent_k8_again"),
                     "bound": res["bound_ms"],
                     "cudnn_bf16_conv": _mean_device(res, "cudnn_bf16_conv"),
                     "int_mm": _mean_device(res, "int_mm")}
            for name, v in reads.items():
                if v is None:
                    unread.add(name)
                else:
                    sums[name] += count * v
            torch.cuda.empty_cache()
        if parent is None:
            sums.pop("parent_k8")
            unread.discard("parent_k8")
        totals[dtype] = {"device_ms_per_b8_call": sums, "convs_per_call": sum(seen.counts.values()),
                         "distinct_shapes": len(seen), "not_read": sorted(unread)}
        print(json.dumps({"dtype": dtype, **totals[dtype]}), flush=True)
    print("card:", card_line(), flush=True)
    return totals


if __name__ == "__main__":
    main()
