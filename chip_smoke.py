"""On-card smoke of the PyTorch port (fovealseg_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: versions, the card's name and power limit, the CUDA kernels built
     from ``fovealseg_torch/csrc`` with nvcc (one process per source, started
     together) and their ``-Xptxas -v`` reports;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, bit-equal, with CUDA-event times;
  3. the main path at full flagship width (HRNetV2-nodownsp + C1, 640x640
     canvas -> 80x80 task, 51 classes, random weights from a seed): the
     serving CLI's entry point at b8, then ``infer(argmax_labels=True)`` at
     b8 and b1 in float32 and bfloat16, with every kernel's launch count read
     from this window only; the output of a served batch is recomputed on the
     host through the plain versions and must be bit-equal; a small input is
     held against the same weights on the host;
  4. summary: the card line, one JSON line of per-kernel numbers, and the
     last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 304


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, n: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``n`` runs, each between two CUDA
    events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def setup():
    import torch

    from fovealseg_torch.ops import build

    log("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("card:", card)
    t = time.perf_counter()
    reports = build.build(["jfa"])
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"  ptxas[{name}]: {line}")
    return card


def flagship(dtype, device):
    import torch

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(80, 80), task_hw_infer=(80, 80), saliency_hw=(80, 80),
                       gaussian_radius=45, num_class=51, arch_encoder="hrnetv2_nodownsp")
    model = DeformSegmentation(cfg, dtype=dtype, device=device)
    return init_weights(model, torch.Generator().manual_seed(SEED))


def frames(batch: int, canvas: int, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, canvas, canvas, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(f).to(device)


def check_jfa(model, device):
    """Phase 2: the class-mode jump flood against its plain version."""
    import torch

    from fovealseg_torch.core.unwarp import argmax_landing_seeds, jfa_rounds_from_grid
    from fovealseg_torch.ops.jfa import full_rounds, nearest_class, nearest_class_plain

    x, f = frames(8, 640, SEED, device)
    out = model.infer(x, f, argmax_labels=True)
    seg_hw = (640, 640)
    valid, cls, cls_bits = argmax_landing_seeds(out["pred"].float(), out["grid"], seg_hw)
    rounds = jfa_rounds_from_grid(out["grid"], seg_hw)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sparse = torch.rand((8, 640, 640), generator=gen) > 0.995
    non_square = torch.rand((8, 480, 640), generator=gen) > 0.99
    cases = [
        ("flagship landing scatter, runtime rounds", valid, cls, rounds),
        ("random sparse, full rounds", sparse.to(device),
         torch.randint(0, 51, sparse.shape, generator=gen, dtype=torch.int32).to(device), None),
        ("non-square 480x640, full rounds", non_square.to(device),
         torch.randint(0, 51, non_square.shape, generator=gen, dtype=torch.int32).to(device), None),
    ]
    result, max_abs_err = None, 0
    for label, v, p, r in cases:
        k_out = nearest_class(v, p, cls_bits, r)
        torch.cuda.synchronize()
        ref = nearest_class_plain(v, p, cls_bits, r)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err, int((k_out - ref).abs().max()))
        if not torch.equal(k_out, ref):
            raise AssertionError(f"jfa kernel != plain on {label}: "
                                 f"{(k_out != ref).sum().item()} pixels differ")
        ms = cuda_time(lambda: nearest_class(v, p, cls_bits, r), 20)
        plain_ms = cuda_time(lambda: nearest_class_plain(v, p, cls_bits, r), 20, warmup=1)
        b, h, w = v.shape
        bound_ms = b * h * w * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3
        n_rounds = int(r) if r is not None else full_rounds(h, w)
        log(f"jfa_class [{label}] {tuple(v.shape)} rounds={n_rounds}: bit-equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes)")
        if result is None:  # the main path's own shapes and data
            result = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, rounds=n_rounds)
    result["max_abs_err"] = max_abs_err
    return result


def time_serving(model, device):
    """b8 fps and b1 latency of infer(argmax_labels=True), CUDA-event timed."""
    import torch

    x8, f8 = frames(8, 640, SEED + 1, device)
    x1, f1 = frames(1, 640, SEED + 2, device)
    b8_ms = cuda_time(lambda: model.infer(x8, f8, argmax_labels=True), 10, warmup=2)
    b1_ms = cuda_time(lambda: model.infer(x1, f1, argmax_labels=True), 20, warmup=2)
    host = []
    for _ in range(10):
        t = time.perf_counter()
        model.infer(x1, f1, argmax_labels=True)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    return dict(b8_ms=b8_ms, b8_fps=8 / (b8_ms / 1e3), b1_ms=b1_ms,
                b1_host_ms=statistics.median(host), calls=2 + 10 + 2 + 20 + 10)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1

    from fovealseg_torch.cli import infer as cli
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter
    from fovealseg_torch.ops.jfa import nearest_class

    device = torch.device("cuda", 0)
    log("== phase 1: setup")
    card = setup()
    log(f"convs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} (PyTorch's default); "
        f"grid solver and resizes: full f32 matmuls")

    log("== phase 2: kernels against their plain versions (b8, 640x640)")
    t = time.perf_counter()
    model32 = flagship(torch.float32, device)
    model16 = flagship(torch.bfloat16, device)
    log(f"flagship built ({sum(p.numel() for p in model32.parameters()) / 1e6:.1f} M params) "
        f"in {time.perf_counter() - t:.1f} s")
    jfa = check_jfa(model32, device)

    log("== phase 3: main path")
    nearest_class.launches = 0
    calls = 0
    t = time.perf_counter()
    cli.main(["--cfg", "fovealseg_tpu/configs/deform.yaml", "--batch", "8", "--num-batches", "3",
              "MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
              "TRAIN.task_input_size", "(80,80)", "TPU.compute_dtype", "bfloat16"])
    calls += 3
    log(f"cli served 3 b8 batches in {time.perf_counter() - t:.1f} s (model build included)")
    x, f = frames(8, 640, SEED + 3, device)
    served = model32.infer(x, f, argmax_labels=True)
    calls += 1
    timings = {}
    for name, model in (("float32", model32), ("bfloat16", model16)):
        timings[name] = tm = time_serving(model, device)
        calls += tm.pop("calls")
        log(f"serving {name}: b8 {tm['b8_ms']:.3f} ms/batch = {tm['b8_fps']:.1f} fps; "
            f"b1 {tm['b1_ms']:.3f} ms (events), {tm['b1_host_ms']:.3f} ms (host clock)")
    torch.cuda.synchronize()
    launches = nearest_class.launches
    log(f"jfa_class launches in the main path: {launches} (infer calls: {calls})")
    if launches != calls:
        raise AssertionError(f"expected {calls} jfa_class launches, counted {launches}")

    label, pred, grid = served["pred_label"], served["pred"], served["grid"]
    if label.shape != (8, 640, 640) or label.dtype != torch.int32:
        raise AssertionError(f"pred_label {tuple(label.shape)} {label.dtype}")
    if int(label.min()) < 0 or int(label.max()) >= 51:
        raise AssertionError("pred_label outside [0, 51)")
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite logits")
    rounds = jfa_rounds_from_grid(grid, (640, 640))
    host = unwarp_argmax_scatter(pred.cpu(), grid.cpu(), (640, 640), rounds=rounds.cpu())
    if not torch.equal(host, label.cpu()):
        raise AssertionError("served pred_label != host recompute through the plain jump flood")
    log(f"served pred_label bit-equal to the host recompute (rounds={int(rounds)})")
    small_agreement = check_small_against_host(device)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("== phase 4: summary")
    kernels = [{
        "name": "jfa_class", "route": "cuda", "source": "fovealseg_torch/csrc/jfa.cu",
        "replaces": "fovealseg_tpu/ops/pallas_jfa.py:209", "launches": launches,
        "max_abs_err": jfa["max_abs_err"], "bit_equal": jfa["max_abs_err"] == 0,
        "ms": jfa["ms"], "kernel_ms": jfa["ms"],
        "plain_ms": jfa["plain_ms"], "bound_ms": jfa["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "rounds": jfa["rounds"],
    }]
    log(json.dumps({"serving": timings, "small_input_label_agreement": small_agreement}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def check_small_against_host(device) -> float:
    """The tiny encoder on a 64x64 canvas, same weights on the card (f32, no
    TF32) and on the host: grid and logits within tolerance, labels agreeing
    on >= 99% of pixels (a landing pixel moves when a grid coordinate
    straddles an integer)."""
    import torch

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
    host = init_weights(DeformSegmentation(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    card = DeformSegmentation(cfg, device=device)
    card.load_state_dict(host.state_dict())
    x, f = frames(2, 64, SEED + 4, "cpu")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.infer(x.to(device), f.to(device), argmax_labels=True)
    ref = host.infer(x, f, argmax_labels=True)
    gerr = (got["grid"].cpu() - ref["grid"]).abs().max().item()
    perr = ((got["pred"].cpu() - ref["pred"]).abs().max() / ref["pred"].abs().max()).item()
    agree = (got["pred_label"].cpu() == ref["pred_label"]).float().mean().item()
    log(f"small input card vs host: grid max err {gerr:.3g}, pred rel err {perr:.3g}, "
        f"label agreement {agree:.4f}")
    if gerr > 1e-5 or perr > 1e-4 or agree < 0.99:
        raise AssertionError("card and host disagree on the small input")
    return agree


if __name__ == "__main__":
    sys.exit(main())
