"""On-card smoke of the PyTorch port (fovealseg_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. setup: versions, the card's name and power limit, the CUDA kernels built
     from ``fovealseg_torch/csrc`` with nvcc (one process per source, started
     together) and their ``-Xptxas -v`` reports;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, bit-equal, with CUDA-event times (one
     call on an idle stream, and back to back), device times from
     torch.profiler, the byte bound and, where PyTorch computes the same
     function, its time both ways (K5: ``index_select`` from the ready int64
     flat indices, and from the int32 index map); K1 also at rounds=1 and on
     a 65x1000 canvas; K5 at C = 51, 1, 2 and 3; the jump flood's launches
     per call and per-trip device times;
  3. the main paths at full flagship width (HRNetV2-nodownsp + C1, 640x640
     canvas -> 80x80 task, 51 classes, random weights from a seed), each with
     every kernel's launch count set to 0 just before it and read just after:
     a. argmax serving: the serving CLI's entry point at b8, then
        ``infer(argmax_labels=True)`` at b8 and b1 in float32 and bfloat16;
        a served batch is recomputed on the host through the plain versions
        and must be bit-equal, and a served bf16 batch's warped image must
        equal the host's warp at the served grid bit for bit; a small input
        is held against the same weights on the host;
     b. score maps and round trips: ``infer(argmax_labels=False)`` at b8 and
        b1 in float32 and bfloat16, one b8 call with the label and image
        round trips, one b2 call with ``rev_deform_interp='BI'`` and one b8
        call with ``TPU.jfa_iters=10``; two frames of a served score map are
        recomputed on the host through the plain versions and must be
        bit-equal; a small input is held against the host;
     c. eval: the eval CLI (``fovealseg_torch.cli.eval.main``) in-process at
        b8 bfloat16, 3 synthetic batches, with the label round trip, Dice,
        hd95 and the trimap on; one batch's labels and round trip are
        recomputed on the host through the plain versions and must be
        bit-equal, and the card's histograms of that batch must equal the
        host metric functions' integer for integer; then one b2 batch each
        of exact 'tri' (held within 1e-5 of the host oracle on one frame),
        'BI', ``MODEL.uniform_sample='nearest'`` and ``'BI'``; eval frames/s,
        host ms per sample of the boundary metrics and of the 'tri' plan;
     d. training: the row gather's backward (K5b) against its plain version
        on the flagship's inverse-warp indices, 'nearest' and 'BI' at C = 51
        and C = 1, 2, 3, bit-equal and the same over two launches, with times
        beside ``index_add_``'s and the deterministic ``index_put_``'s; one
        train step of the tiny pair on the card against the host (loss, the
        four groups' gradients, updated parameters, BN statistics; TF32 off),
        and one ``MODEL.loss_at_high_res`` step each in 'nearest' and 'BI'
        whose saliency-net gradients must be non-zero and match the host's;
        the flagship's default training step at b8 in float32 and bfloat16
        (samples/s, device-busy ms and idle share over two profiled steps,
        kernels per step, every loss finite); the flagship with
        ``MODEL.loss_at_high_res`` at b8 (K2, K5 and K5b once per step;
        'BI': K4, K5 and K5b); the train CLI (2 epochs x 3 iterations, then
        one more epoch resumed from ``epoch_last``; its checkpoints written
        by ``AsyncSaver``, ``TPU.async_checkpoint``'s default) and the eval
        CLI on its epoch-3 checkpoint; the checkpoint write of the
        flagship's b8 f32 Adam state, two cadence epochs synchronous and
        through ``AsyncSaver`` (seconds the training thread blocks, seconds
        until the write drains with a training step run meanwhile, bytes),
        both sets loading bit-equal;
     e. the other encoders and saliency nets at full width: SegFormer-B5
        (``segformer``, fc_dim 1024) and DeepLabV3-ResNet101 (``deeplab``),
        each with argmax labels and score maps through ``infer`` at b8 and b1
        in float32 and bfloat16 (CUDA events, host clock, torch.profiler),
        one b8 bfloat16 batch of the eval CLI, the default train step at b8
        in float32 and bfloat16 and one ``MODEL.loss_at_high_res`` 'nearest'
        step; the HRNet flagship with each ResNetZoom saliency net
        (``resnet18``, ``resnet18_nonsyn``, ``resnet18_stride1``,
        ``resnet10_nonsyn``) at b8 float32, argmax labels and score maps.
        Each path's counts are read just after it, and K1, K2, K5 and K5b
        are held bit-equal to their plain versions on the inputs the path
        gave them (copied on the way in); the nets at a cut depth on the
        card against the host (TF32 off, dropout off);
     f. data parallelism (``fovealseg_torch/parallel``), its ranks started by
        ``parallel/launch.py``: one NCCL rank under DDP against the
        single-process step from the same weights and batch, b8 float32,
        deterministic cuDNN, default and ``loss_at_high_res`` 'nearest'
        (loss, parameters and BN statistics bit-equal; the DDP 'nearest'
        step's counts read in the rank just after it, K2, K5 and K5b held on
        its own inputs), then both default steps timed in turn (the
        median of 12 each on the host clock, samples/s at it, device busy);
        two gloo ranks on the one
        card, the flagship at a global b8 with cross-rank BN: after one step
        every parameter and BN statistic bit-equal between the ranks; the
        tiny two-rank step on the card against the same step on the host,
        held to a float64 host yardstick (``float64_nets``); the serving CLI
        with ``--mesh 1`` (NCCL) and ``--mesh 2`` (gloo, both ranks on the
        card) against one process: labels bit-equal, K1 launched once per
        rank per micro-batch (counted in the rank processes, which start at
        0), K1 held on the single process's inputs;
     g. real data, in a temporary directory: an LVIS-format json (images
        480x640 to 640x640, JPEGs) cooked through ``cli.cook.main`` (24
        train, 8 valid), the flagship trained on it through
        ``cli.train.main --data`` at b8 f32 (two reconciled epochs of 3
        steps; the first batch on the card bit-equal to the reader's host
        batch; samples/s beside phase 3d's synthetic figure) and its
        checkpoint evaluated through ``cli.eval.main --data`` (K1, K2, K5
        once each); the ADE20K multi-scale evaluation
        (``cli.eval_odgt.main``, ``configs/ade20k.yaml``: 150 classes, 5
        scales, the label round trip) of the flagship on four records
        (512x683, 683x512, 375x501, 1024x1365), K2 and K5 counted per record
        and held bit-equal to their plain versions (and timed) on the path's
        own inputs at 1024x1365 and 375x501 (C = 150 and 1), one record's
        labels with the plain K2 and K5 bit-equal to the kernels', the
        device time per scale under torch.profiler, the largest device
        round count, peak memory, and ``--no-deform`` on one record;
     h. the 2-D mesh and spatial serving: (a) the flagship on
        ``TPU.mesh_shape (2,2)``, four gloo ranks on the one card, one
        default and one ``loss_at_high_res`` 'nearest' SGD step on a global
        b8 batch (dropout on, the global batch's mask), each against the
        one-process step on the same batch, TF32 off on both sides: in f32
        (metrics rtol 1e-4, the encoder's and decoder's parameters rtol
        2e-3 atol 2e-5, each group's update norm within 10%) and as its
        float64 witness (``float64_nets``), which holds the CPU test's
        tolerances and more (every parameter and BN statistic rtol 2e-3
        atol 2e-5, each group's update within 1e-5 of its norm in direction
        and size); one process's f32 update against its f64 one; the
        'nearest' steps' K2, K5 and K5b counted in each rank just after
        them and held on their own inputs; each rank's parameter and Adam
        moment bytes against one process's, wall and device-busy ms and
        kernels per f32 step; (b) ``--spatial 2`` (two gloo ranks on the
        card), b1 f32, for the flagship, SegFormer-B5 and DeepLabV3-R101
        at full width (2 warm-up and 3 timed frames each): per frame the
        wall, device busy, kernels and exchanges beside one process's (and
        the flagship's beside phase 3a's b1), K1 once per frame on each
        rank and held on each frame's own inputs, labels equal to one
        process's where its scores decide them; (c) the serving CLI with
        ``--mesh 2 --backend gloo`` and ``resnet18_nonsyn`` (b8) against
        one process's model on the same frames: at most 100 decided pixels
        differ;
     i. the serving artifact and the zoo: (a) the flagship exported through
        ``cli.export`` at b8 (f32 and bf16 argmax, f32 scores), each
        program loaded and run by a process that imports only
        ``fovealseg_torch.ops`` and, in this process, beside the live
        ``infer``: outputs bit-equal, K1 (or K2 and K5) counted once per
        call by the operators' CUDA kernels, per call the host clock, CUDA
        events, device-busy ms and kernels; ``--format torch`` read back
        strictly, equal to the model's state dict; (b) the zoo at published
        widths, b2 f32 and bf16: the CSAIL ADE20K pairs
        (resnet101dilated + ppm_deepsup, mobilenetv2dilated + c1_deepsup,
        resnet50 + upernet; 150 classes, 512x683) and SegHRNet-W48 (19
        classes, 512x1024), each f32 module against the host on a small
        input (TF32 off, 1e-4); (c) ``BucketedDeform`` serving the
        flagship's weights at 512x683 and 1024x1365, K1 once per call,
        labels bit-equal to the host recompute; the registered operators'
        cost per call (K1 and K5 at C = 1 through the wrapper and through
        the CUDA kernel function, CUDA events);
     j. the host-only remainder on the card at the flagship's geometry: the
        DynamicFocus sampler's ``get_grid`` ([8, 144, 144, 1], kernel 65,
        TF32 allowed) within 1e-5 of the host, ``int_round_scale_grid`` to
        640x640 equal to the host's, ``deformed_unsampler`` of [8, 80, 80,
        51] values (K4 and K5 counted once each, held bit-equal on their own
        inputs, the output bit-equal to the host's plain recompute; CUDA
        events and device ms), ``interp2d_apply``'s gradient within 1e-5 of
        the host's, ``device_memory_stats()``;
     k. W8A8 serving (``TPU.quantize int8``, ``ops/quant.py``): K6, K7 and K8
        bit-equal to their plain versions and timed (events, back to back,
        device ms, bound, plain; K6 beside ``torch.linalg.vector_norm(x,
        inf)``, K7 beside ``torch.quantize_per_tensor`` (f32), K8 beside
        ``torch._int_mm`` of the unfolded codes and cuDNN's bf16 conv; the
        one-call ``w8a8_conv2d`` that serving runs beside the three calls)
        at HRNet's 3x3 convs of 128, 256 and 512 channels and C1's 960 ->
        240 (bf16 and f32) at b8; the serving CLI at
        b8 bf16 with ``TPU.quantize int8``, then ``infer(argmax_labels=True)``
        at b8 and b1 in f32 and bf16 on the quantized flagship, K6, K7 and
        K8 counted once per quantized conv per call and held on each
        distinct conv shape's own inputs; b8 device busy, idle share and
        kernels per call beside float serving's, and K8's device ms per
        call (by its kernel's name) and share of W8A8 busy; a b2 bf16 served call's 184
        quantized convs recomputed on the host through the plain versions
        and its labels through the plain flood, bit-equal; the W8A8 labels'
        agreement with float serving; one eval-CLI b8 bf16 batch;
  4. summary: the card line, one JSON line of per-kernel numbers, and the
     last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 304
CANVAS = 640


def log(*a):
    print(*a, flush=True)


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
    reports = build.build(list(build.SOURCES))
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    log(f"profiler clock probe: {json.dumps(profiler_clock_probe())}")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"  ptxas[{name}]: {line}")
    return card


def flagship(dtype, device, **overrides):
    import torch

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(**{**dict(task_hw=(80, 80), task_hw_infer=(80, 80), saliency_hw=(80, 80),
                                 gaussian_radius=45, num_class=51,
                                 arch_encoder="hrnetv2_nodownsp"), **overrides})
    model = DeformSegmentation(cfg, dtype=dtype, device=device)
    return init_weights(model, torch.Generator().manual_seed(SEED))


def frames(batch: int, canvas: int, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, canvas, canvas, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(f).to(device)


def labels(batch: int, canvas: int, seed: int, device, block: int = 32):
    """Label maps of random classes in block x block squares, so that the
    label round trip keeps most of them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 51, (batch, -(-canvas // block), -(-canvas // block)))
    y = cells.repeat(block, axis=1).repeat(block, axis=2)[:, :canvas, :canvas]
    return torch.from_numpy(np.ascontiguousarray(y, dtype=np.int32)).to(device)


def counters():
    from fovealseg_torch.ops import gather, jfa

    return {"jfa_class": jfa.nearest_class, "jfa_relpay": jfa.nearest_payload_packed,
            "jfa_payload": jfa.nearest_payload, "jfa_seed": jfa.nearest_seed,
            "row_gather": gather.row_gather, "row_gather_backward": gather.row_gather_backward}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    import torch

    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def check_counts(label, counts, expected):
    log(f"launches in {label}: {json.dumps(counts)}")
    if counts != expected:
        raise AssertionError(f"{label}: expected launches {expected}, counted {counts}")


def _ms(v) -> str:
    return "not read" if v is None else f"{v:.4f} ms"


# every profiled read that saw no kernel, the first DIAGNOSED_READS with
# their diagnosis (a few seconds each; the later ones repeat the finding)
DROPPED_READS: list = []
DIAGNOSED_READS = 8


def _launch_lag_ms(prof):
    """Launch and kernel records of a CPU + CUDA profiled run, matched by
    correlation id: ({correlation id: launch record}, [kernel records],
    [each matched kernel's start minus its launch's start, ms])."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id(): e for e in evs
                if e.device_type() == DeviceType.CPU and "aunch" in e.name()}
    kernels = [e for e in evs if e.device_type() == DeviceType.CUDA]
    lag = [(k.start_ns() - launches[k.correlation_id()].start_ns()) / 1e6 for k in kernels
           if k.correlation_id() in launches]
    return launches, kernels, lag


def profiler_clock_probe(pad_s: float = 0.2) -> dict:
    """One small kernel under CPU and CUDA activities with ``pad_s`` seconds
    of host time inside the window on both sides: its kernel's start minus
    its launch's start (ms), the offset between the profiler's device and
    host clocks plus the launch latency."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    launches, kernels, lag = _launch_lag_ms(prof)
    return {"launch_records": len(launches), "kernel_records": len(kernels),
            "kernel_start_after_launch_ms": lag}


def dropped_read_diagnosis(fn, n: int, pad_s: float = 0.2) -> dict:
    """Why a profiled run of ``fn`` saw no kernel. The same ``n`` calls (1)
    under CPU and CUDA activities: the runtime's launch records against the
    kernels' records, matched by correlation id, and each kernel's start
    after its launch; (2)-(4) under CUDA activity, as ``device_ms`` runs
    them but with ``pad_s`` seconds of host time inside the profiled window
    after the closing synchronise, before the first call, and both: what
    each reads; (5) ``profiler_clock_probe``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    session_ms = (time.perf_counter() - t0) * 1e3
    launches, kernels, lag = _launch_lag_ms(prof)
    start = prof.profiler.kineto_results.trace_start_ns()
    seen = {k.correlation_id() for k in kernels}
    missing = [(e.start_ns() - start) / 1e6 for c, e in launches.items() if c not in seen]
    res = {"launch_records": len(launches), "kernel_records": len(kernels),
           "kernel_start_after_launch_ms": [min(lag), max(lag)] if lag else None,
           "missing_launches_ms_after_trace_start": [min(missing), max(missing)]
           if missing else None, "session_ms": session_ms, "pad_s": pad_s}
    for variant, before, after in (("pad_after", 0.0, pad_s), ("pad_before", pad_s, 0.0),
                                   ("pad_both", pad_s, pad_s)):
        with profile(activities=[ProfilerActivity.CUDA]) as padded:
            time.sleep(before)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(after)
        pk = [e for e in padded.events() if e.device_type == DeviceType.CUDA]
        res[f"{variant}_kernels_per_call"] = len(pk) / n
        res[f"{variant}_device_ms"] = sum(e.time_range.elapsed_us() for e in pk) / 1e3 / n
    res["clock_probe"] = profiler_clock_probe(pad_s)
    return res


def profiled_ms(label, fn, n: int, tries: int = 3):
    """Device ms per call of ``fn`` under torch.profiler (``device_ms``), or
    None where no run saw a kernel: a run that launched kernels and holds no
    kernel record is not a time. From phase 3g on, the profiler holds no
    kernel record in about every other short run of this process, so such a
    run is kept in ``DROPPED_READS`` (the first ``DIAGNOSED_READS`` of the
    process diagnosed, ``dropped_read_diagnosis``) and read again, up to
    ``tries`` runs in all."""
    from fovealseg_torch.tools.profile_gather import device_ms

    for attempt in range(tries):
        ms, per_call, _ = device_ms(fn, n)
        if per_call > 0:
            if attempt:
                DROPPED_READS[-1]["read_on_run"] = attempt + 1
            return ms
        if attempt == 0:
            diagnose = len(DROPPED_READS) < DIAGNOSED_READS
            diag = dropped_read_diagnosis(fn, n) if diagnose else {}
            DROPPED_READS.append({"label": label, **diag})
            log(f"profiler read no kernel for {label}: {json.dumps(diag)}")
    log(f"profiler read no kernel for {label} in {tries} runs")
    return None


def hold(name, label, kernel, plain, bound_ms, libraries=None, n=20, bound_by="bytes"):
    """Run ``kernel`` and ``plain`` once, require bit-equal outputs, then
    time both: the kernel in CUDA events around one call on an idle stream
    (``ms``), over back-to-back calls (``loop_ms``) and as the sum of its
    kernels' device times under torch.profiler (``device_ms``, None where
    the profiler saw no kernel: ``profiled_ms``); each of
    ``libraries`` ({name: fn}, the first one is ``library``) in events and
    device time. Returns the numbers."""
    import torch

    from fovealseg_torch.tools.profile_gather import events_ms, loop_ms

    k_out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    if k_out.shape != ref.shape or k_out.dtype != ref.dtype:
        raise AssertionError(f"{name} [{label}]: {tuple(k_out.shape)} {k_out.dtype} != "
                             f"plain {tuple(ref.shape)} {ref.dtype}")
    bits = torch.int32 if k_out.element_size() == 4 else k_out.dtype
    if not torch.equal(k_out.view(bits), ref.view(bits)):
        raise AssertionError(f"{name} kernel != plain on {label}: "
                             f"{(k_out != ref).sum().item()} elements differ")
    del k_out, ref
    err = 0.0  # bit-equal, so every element's difference is 0
    ms = events_ms(kernel, n)
    dev_ms = profiled_ms(f"{name} [{label}]", kernel, n)
    lp_ms = loop_ms(kernel, n)
    plain_ms = events_ms(plain, n, warmup=1)
    libs = {lib: {"ms": events_ms(fn, n), "device_ms": profiled_ms(f"{lib} [{label}]", fn, n)}
            for lib, fn in (libraries or {}).items()}
    library_ms = next(iter(libs.values()))["ms"] if libs else None
    log(f"{name} [{label}]: bit-equal; kernel {ms:.4f} ms events, {lp_ms:.4f} ms back to back, "
        f"{_ms(dev_ms)} device; plain {plain_ms:.4f} ms; "
        + "".join(f"{lib} {v['ms']:.4f} ms events, {_ms(v['device_ms'])} device; "
                  for lib, v in libs.items())
        + f"bound {bound_ms:.4f} ms ({bound_by})")
    return dict(ms=ms, device_ms=dev_ms, loop_ms=lp_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms, libraries=libs, max_abs_err=err, bit_equal=True)


def check_jfa(model, device):
    """Phase 2: the class-mode jump flood (K1) against its plain version."""
    import torch

    from fovealseg_torch.core.unwarp import argmax_landing_seeds, jfa_rounds_from_grid
    from fovealseg_torch.ops.jfa import full_rounds, nearest_class, nearest_class_plain

    x, f = frames(8, CANVAS, SEED, device)
    out = model.infer(x, f, argmax_labels=True)
    seg_hw = (CANVAS, CANVAS)
    valid, cls, cls_bits = argmax_landing_seeds(out["pred"].float(), out["grid"], seg_hw)
    rounds = jfa_rounds_from_grid(out["grid"], seg_hw)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    sparse = torch.rand((8, CANVAS, CANVAS), generator=gen) > 0.995
    non_square = torch.rand((8, 480, CANVAS), generator=gen) > 0.99
    wide = torch.rand((8, 65, 1000), generator=gen) > 0.99
    cases = [
        ("flagship landing scatter, runtime rounds", valid, cls, rounds),
        ("flagship landing scatter, rounds=1", valid, cls, 1),
        ("random sparse, full rounds", sparse.to(device),
         torch.randint(0, 51, sparse.shape, generator=gen, dtype=torch.int32).to(device), None),
        ("non-square 480x640, full rounds", non_square.to(device),
         torch.randint(0, 51, non_square.shape, generator=gen, dtype=torch.int32).to(device), None),
        ("65x1000, full rounds", wide.to(device),
         torch.randint(0, 51, wide.shape, generator=gen, dtype=torch.int32).to(device), None),
    ]
    result = None
    for label, v, p, r in cases:
        b, h, w = v.shape
        n_rounds = int(r) if r is not None else full_rounds(h, w)
        res = hold("jfa_class", f"{label} {tuple(v.shape)} rounds={n_rounds}",
                   lambda: nearest_class(v, p, cls_bits, r),
                   lambda: nearest_class_plain(v, p, cls_bits, r),
                   b * h * w * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3)
        if result is None:  # the main path's own shapes and data
            result = dict(res, rounds=n_rounds)
        result["max_abs_err"] = max(result["max_abs_err"], res["max_abs_err"])
    result["trips"] = flood_trips(f"jfa_class flagship landing scatter, rounds={result['rounds']}",
                                  lambda: nearest_class(valid, cls, cls_bits, rounds),
                                  full_rounds(CANVAS, CANVAS))
    return result


def flood_trips(label, fn, full):
    """One call of a jump-flood wrapper under torch.profiler: how many
    kernels named jfa_* it launched (the design launches full + 1) and each
    one's device time in microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trips = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "jfa_" in e.name]
    log(f"{label}: {len(trips)} jfa_* launches per call (full + 1 = {full + 1}); device us per "
        f"trip: {', '.join(f'{us:.1f}' for us in trips)}; sum {sum(trips):.1f} us")
    return dict(launches_per_call=len(trips), us=trips)


def check_new_kernels(model, device):
    """Phase 2: K2-K5 against their plain versions on the flagship's own
    inverse-warp inputs (b8, 640x640, 80x80 task, 51 classes)."""
    import torch

    from fovealseg_torch.core.grid import grid_from_index, inverse_grid_index
    from fovealseg_torch.core.unwarp import halfpixel_avg, jfa_rounds_from_grid
    from fovealseg_torch.ops import gather, jfa

    x, f = frames(8, CANVAS, SEED + 5, device)
    out = model.infer(x, f, argmax_labels=True)
    seg_hw = (CANVAS, CANVAS)
    task_idx, valid = inverse_grid_index(out["grid"], seg_hw)
    rounds = jfa_rounds_from_grid(out["grid"], seg_hw)
    b, h, w = valid.shape
    th, tw = out["pred"].shape[1:3]
    pay_bits = (th * tw - 1).bit_length()
    px = b * h * w
    full = jfa.full_rounds(h, w)
    res = {}
    n_rounds = int(rounds)
    res["jfa_relpay"] = dict(hold(
        "jfa_relpay", f"flagship inverse_grid_index, runtime rounds={n_rounds}",
        lambda: jfa.nearest_payload_packed(valid, task_idx, pay_bits, rounds),
        lambda: jfa.nearest_payload_packed_plain(valid, task_idx, pay_bits, rounds),
        px * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3), rounds=n_rounds)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    sparse = (torch.rand((b, h, w), generator=gen) > 0.995).to(device)
    wide = torch.randint(0, 2**30, sparse.shape, generator=gen, dtype=torch.int32).to(device)
    k3_sparse = hold("jfa_payload", f"random sparse, 30-bit payload, full rounds={full}",
                     lambda: jfa.nearest_payload(sparse, wide, None),
                     lambda: jfa.nearest_payload_plain(sparse, wide, None),
                     px * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3)
    res["jfa_payload"] = dict(hold(
        "jfa_payload", f"flagship inverse_grid_index, full rounds={full}",
        lambda: jfa.nearest_payload(valid, task_idx, None),
        lambda: jfa.nearest_payload_plain(valid, task_idx, None),
        px * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3), rounds=full)
    res["jfa_payload"]["max_abs_err"] = max(res["jfa_payload"]["max_abs_err"],
                                            k3_sparse["max_abs_err"])
    res["jfa_seed"] = dict(hold(
        "jfa_seed", f"flagship landing mask, full rounds={full}",
        lambda: jfa.nearest_seed(valid, None), lambda: jfa.nearest_seed_plain(valid, None),
        px * (1 + 4) / HBM_BYTES_PER_S * 1e3), rounds=full)
    res["jfa_relpay"]["trips"] = flood_trips(
        f"jfa_relpay flagship inverse_grid_index, rounds={n_rounds}",
        lambda: jfa.nearest_payload_packed(valid, task_idx, pay_bits, rounds), full)
    res["jfa_payload"]["trips"] = flood_trips(
        f"jfa_payload flagship inverse_grid_index, rounds={full}",
        lambda: jfa.nearest_payload(valid, task_idx, None), full)

    tidx = jfa.nearest_payload_packed(valid, task_idx, pay_bits, rounds)
    seeds = jfa.nearest_seed(valid, None)
    p2 = halfpixel_avg(out["pred"].float()).reshape(b, -1, 51).contiguous()
    grid_inv = grid_from_index(task_idx, valid, (th, tw))
    grid_inv = torch.where(torch.isnan(grid_inv), 0.0, grid_inv).reshape(b, h * w, 2)
    y_task = torch.randint(0, 51, (b, p2.shape[1], 1), generator=gen, dtype=torch.int32).to(device)
    image = (x.reshape(b, h * w, 3) * valid.reshape(b, h * w, 1)).contiguous()
    cases = [(f"score map {list(p2.shape)} at K2's output", p2, tidx),
             (f"labels int32 {list(y_task.shape)} at K2's output", y_task, tidx),
             (f"filled grid {list(grid_inv.shape)} at K4's output", grid_inv.contiguous(),
              seeds.reshape(b, h * w)),
             (f"image {list(image.shape)} at K4's output", image, seeds.reshape(b, h * w))]
    res["row_gather"] = {"cases": []}
    for label, table, idx in cases:
        t_rows, c = table.shape[1], table.shape[2]
        flat = (idx.reshape(b, -1).long().clamp(0, t_rows - 1)
                + torch.arange(b, device=device).view(b, 1) * t_rows).reshape(-1)
        off32 = torch.arange(b, device=device, dtype=torch.int32).view(b, 1) * t_rows
        table2 = table.reshape(-1, c)
        idx2 = idx.reshape(b, -1)
        r = hold("row_gather", label, lambda: gather.row_gather(table, idx),
                 lambda: gather.row_gather_plain(table, idx),
                 (idx.numel() * c * 4 + idx.numel() * 4 + table.numel() * 4)
                 / HBM_BYTES_PER_S * 1e3,
                 libraries={"index_select": lambda: torch.index_select(table2, 0, flat),
                            "index_select_int32": lambda: torch.index_select(
                                table2, 0, (idx2 + off32).view(-1))})
        out_k = gather.row_gather(table, idx)
        r["variant"] = gather.VARIANT_NAMES[gather.gather_variant(
            c, idx2.shape[1], table.data_ptr(), idx.data_ptr(), out_k.data_ptr())]
        del out_k
        res["row_gather"]["cases"].append(dict(r, label=label, channels=c))
        if "ms" not in res["row_gather"]:  # the score map: the main path's largest gather
            res["row_gather"].update(r)
        res["row_gather"]["max_abs_err"] = max(res["row_gather"]["max_abs_err"], r["max_abs_err"])
    return res


def time_infer(model, device, n8=10, n1=20, **kw):
    """b8 fps and b1 latency of ``infer(**kw)``, CUDA-event timed (``n8`` and
    ``n1`` calls after 2 warm-up calls each), and b1 on the host clock
    (``n1 // 2`` calls). Returns the numbers and the count of calls made."""
    import torch

    from fovealseg_torch.tools.profile_gather import events_ms

    x8, f8 = frames(8, CANVAS, SEED + 1, device)
    x1, f1 = frames(1, CANVAS, SEED + 2, device)
    b8_ms = events_ms(lambda: model.infer(x8, f8, **kw), n8, warmup=2)
    b1_ms = events_ms(lambda: model.infer(x1, f1, **kw), n1, warmup=2)
    host = []
    for _ in range(n1 // 2):
        t = time.perf_counter()
        model.infer(x1, f1, **kw)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    return dict(b8_ms=b8_ms, b8_fps=8 / (b8_ms / 1e3), b1_ms=b1_ms,
                b1_host_ms=statistics.median(host)), 2 + n8 + 2 + n1 + n1 // 2


def argmax_path(model32, model16, device):
    """Phase 3a: argmax serving through the CLI and ``infer``."""
    import torch

    from fovealseg_torch.cli import infer as cli
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter

    reset_counts()
    calls = 0
    t = time.perf_counter()
    cli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--batch", "8", "--num-batches", "3",
              "MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
              "TRAIN.task_input_size", "(80,80)", "TPU.compute_dtype", "bfloat16"])
    calls += 3
    log(f"cli served 3 b8 batches in {time.perf_counter() - t:.1f} s (model build included)")
    x, f = frames(8, CANVAS, SEED + 3, device)
    served = model32.infer(x, f, argmax_labels=True)
    calls += 1
    timings = {}
    for name, model in (("float32", model32), ("bfloat16", model16)):
        tm, n = time_infer(model, device, argmax_labels=True)
        timings[name] = tm
        calls += n
        log(f"serving {name}: b8 {tm['b8_ms']:.3f} ms/batch = {tm['b8_fps']:.1f} fps; "
            f"b1 {tm['b1_ms']:.3f} ms (events), {tm['b1_host_ms']:.3f} ms (host clock)")
    counts = read_counts()
    check_counts("the argmax path", counts, {**dict.fromkeys(counts, 0), "jfa_class": calls})

    # one b8 bf16 call: its warp rounds after every op, on the card as on the host
    from fovealseg_torch.core.warp import grid_sample

    served16 = model16.infer(x, f, argmax_labels=True)
    calls += 1
    host16 = grid_sample(x.cpu().to(torch.bfloat16), served16["grid"].cpu())
    if served16["x_sampled"].dtype != torch.bfloat16 or not torch.equal(
            host16.view(torch.int16), served16["x_sampled"].cpu().view(torch.int16)):
        raise AssertionError("served bf16 x_sampled != host recompute of the warp")
    log("served bf16 x_sampled (b8) bit-equal to the host recompute of the warp "
        "at the served grid")
    del served16, host16

    label, pred, grid = served["pred_label"], served["pred"], served["grid"]
    if label.shape != (8, CANVAS, CANVAS) or label.dtype != torch.int32:
        raise AssertionError(f"pred_label {tuple(label.shape)} {label.dtype}")
    if int(label.min()) < 0 or int(label.max()) >= 51:
        raise AssertionError("pred_label outside [0, 51)")
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite logits")
    rounds = jfa_rounds_from_grid(grid, (CANVAS, CANVAS))
    host = unwarp_argmax_scatter(pred.cpu(), grid.cpu(), (CANVAS, CANVAS), rounds=rounds.cpu())
    if not torch.equal(host, label.cpu()):
        raise AssertionError("served pred_label != host recompute through the plain jump flood")
    log(f"served pred_label bit-equal to the host recompute (rounds={int(rounds)})")
    return timings, counts


def scoremap_path(model32, model16, device):
    """Phase 3b: score maps, the round trips, 'BI' and a fixed round count."""
    import torch

    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_prediction_fast

    model_bi = flagship(torch.float32, device, rev_deform_interp="BI")
    model_r10 = flagship(torch.float32, device, jfa_iters=10)
    for m in (model_bi, model_r10):
        m.load_state_dict(model32.state_dict())
    x, f = frames(8, CANVAS, SEED + 7, device)
    y = labels(8, CANVAS, SEED + 8, device)
    seg = CANVAS * CANVAS

    reset_counts()
    expected = dict.fromkeys(counters(), 0)
    timings = {}
    for name, model in (("float32", model32), ("bfloat16", model16)):
        tm, n = time_infer(model, device)
        timings[name] = tm
        expected["jfa_relpay"] += n
        expected["row_gather"] += n
        log(f"score map {name}: b8 {tm['b8_ms']:.3f} ms/batch = {tm['b8_fps']:.1f} fps; "
            f"b1 {tm['b1_ms']:.3f} ms (events), {tm['b1_host_ms']:.3f} ms (host clock)")
    served = model32.infer(x, f)
    expected["jfa_relpay"] += 1
    expected["row_gather"] += 1
    trips = model32.infer(x, f, y=y, y_sampled_reverse=True, x_sampled_reverse=True)
    expected["jfa_relpay"] += 2  # score map, label round trip
    expected["jfa_seed"] += 1  # image round trip
    expected["row_gather"] += 3
    bi = model_bi.infer(x[:2], f[:2])
    expected["jfa_seed"] += 1
    expected["row_gather"] += 1
    r10 = model_r10.infer(x, f)
    expected["jfa_payload"] += 1  # 10 rounds > 7: K2's fallback
    expected["row_gather"] += 1
    counts = read_counts()
    check_counts("the score-map path", counts, expected)

    checks = {}
    for label, out, shape in (("pred_sampled", served["pred_sampled"], (8, CANVAS, CANVAS, 51)),
                              ("y_sampled_reverse", trips["y_sampled_reverse"],
                               (8, CANVAS, CANVAS)),
                              ("x_sampled_reverse", trips["x_sampled_reverse"],
                               (8, CANVAS, CANVAS, 3)),
                              ("BI pred_sampled", bi["pred_sampled"], (2, CANVAS, CANVAS, 51)),
                              ("jfa_iters=10 pred_sampled", r10["pred_sampled"],
                               (8, CANVAS, CANVAS, 51))):
        if tuple(out.shape) != shape or out.dtype != torch.float32:
            raise AssertionError(f"{label}: {tuple(out.shape)} {out.dtype}, expected {shape} f32")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label}: non-finite values")
    yr = trips["y_sampled_reverse"]
    if int(yr.min()) < 0 or int(yr.max()) >= 51 or not torch.equal(yr, yr.round()):
        raise AssertionError("y_sampled_reverse is not class ids in [0, 51)")
    checks["round_trip_label_agreement"] = float((yr == y.float()).float().mean())

    # two frames of the served score map, recomputed on the host from the
    # same pred, grid and rounds through the plain versions
    pred, grid = served["pred"], served["grid"]
    rounds = jfa_rounds_from_grid(grid, (CANVAS, CANVAS))
    task_idx, valid = inverse_grid_index(grid[:2].cpu(), (CANVAS, CANVAS))
    host = unwarp_prediction_fast(pred[:2].float().cpu(), task_idx, valid, None, rounds.cpu())
    if not torch.equal(host.view(torch.int32), served["pred_sampled"][:2].cpu().view(torch.int32)):
        raise AssertionError("served pred_sampled != host recompute through the plain versions")
    log(f"served pred_sampled (frames 0-1) bit-equal to the host recompute "
        f"(rounds={int(rounds)}); round-trip label agreement "
        f"{checks['round_trip_label_agreement']:.4f} over {8 * seg} pixels")
    del served, trips, bi, r10, model_bi, model_r10
    torch.cuda.empty_cache()
    return timings, counts, checks


EVAL_FLAGS = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--canvas", str(CANVAS)]
EVAL_OPTS = ["MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
             "TRAIN.task_input_size", "(80,80)", "TPU.compute_dtype", "bfloat16"]


def check_result(label, result, batches, need=()):
    """The eval CLI's result: the JAX CLI's keys (and ``need``), finite, in
    range. hd95 is left out by both CLIs when no frame's prediction has a
    border."""
    need = {"mean_iou", "pixel_acc", "num_batches", "per_class_iou", "y_reverse_iou", *need}
    if not need <= set(result) or result["num_batches"] != batches:
        raise AssertionError(f"{label}: eval result malformed: {result}")
    for k in ("mean_iou", "pixel_acc", "dice", "y_reverse_iou", "hd95"):
        if k in result and not (math.isfinite(result[k]) and result[k] >= 0):
            raise AssertionError(f"{label}: {k} = {result[k]}")
    if not all(0 <= result[k] <= 1 for k in ("mean_iou", "pixel_acc", "dice", "y_reverse_iou")
               if k in result):
        raise AssertionError(f"{label}: a ratio outside [0, 1]: {result}")


def eval_checkpoint(model, device, ckpt_dir) -> None:
    """Write ``model``'s weights as the 4-file set with the decoder's
    background head moved, so that the labels split each frame into
    foreground and background and the metrics are not all zero. On a
    synthetic batch: the mask conv's bias minus the median of its
    pre-activation (the mask then spans (-0.5, 0.5) around 0), and the
    background class's bias plus 8x the largest foreground logit (it wins
    where the mask passes ~1/8)."""
    import os

    import torch

    from fovealseg_torch.train.checkpoint import SUBMODULE_OF_FILE

    seen = []
    hook = model.decoder.conv_last.register_forward_hook(lambda m, i, o: seen.append(o))
    x, f = frames(8, CANVAS, SEED + 11, device)
    fg_max = model.infer(x, f, argmax_labels=True)["pred"][..., :50].float().abs().amax()
    hook.remove()
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd["decoder.conv_last.bias"] -= seen[0].float().median()
    sd["decoder.cls_net.fc.bias"][50] += 8.0 * fg_max
    os.makedirs(ckpt_dir, exist_ok=True)
    for kind, sub in SUBMODULE_OF_FILE.items():
        torch.save({k[len(sub) + 1:]: v.cpu() for k, v in sd.items() if k.startswith(sub + ".")},
                   os.path.join(ckpt_dir, f"{kind}_epoch_0.pth"))


def eval_path(card, model16, device, out_dir):
    """Phase 3c: the eval CLI at full flagship width, then one b2 batch of
    each other inverse warp the eval reaches, all on one 4-file checkpoint
    (``eval_checkpoint``)."""
    import torch

    from fovealseg_torch.cli import eval as cli
    from fovealseg_torch.core import metrics as M
    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import (
        jfa_rounds_from_grid,
        unwarp_argmax_scatter,
        unwarp_labels_fast,
    )
    from fovealseg_torch.native.interp2d import build_fill_plan, unwarp_prediction_tri

    t_phase = time.perf_counter()
    eval_checkpoint(model16, device, f"{out_dir}/ckpt")
    ckpt = ["--torch-ckpt", f"{out_dir}/ckpt", "--torch-epoch", "0"]
    seen, totals = [], [0, 0]

    def keep(out, pred, gt, acc):
        # the batch's outputs and what the card's accumulator gained from it
        seen.append((out, pred, gt, acc.inter - totals[0], acc.union - totals[1]))
        totals[:] = [acc.inter.clone(), acc.union.clone()]

    reset_counts()
    timing = {}
    result = cli.main(EVAL_FLAGS + ckpt + ["--num-batches", "3"] + EVAL_OPTS
                      + ["VAL.batch_size", "8", "VAL.y_sampled_reverse", "True", "VAL.dice", "True",
                         "VAL.hd95", "True", "VAL.trimap", "True", "DIR", f"{out_dir}/b8"],
                      timing=timing, on_batch=keep)
    counts = read_counts()
    check_counts("the eval path (3 b8 batches)", counts,
                 {**dict.fromkeys(counts, 0), "jfa_class": 3, "jfa_relpay": 3, "row_gather": 3})
    check_result("eval b8", result, 3, need=("dice", "trimap_acc"))
    fps = timing["frames"] / timing["seconds"]
    log(f"eval b8 bf16: {json.dumps({k: v for k, v in result.items() if k != 'per_class_iou'})}")
    log(f"eval frames/s {fps:.2f} ({timing['frames']} frames in {timing['seconds']:.3f} s, "
        f"{timing['note']}) on {card}")

    # one batch recomputed on the host through the plain versions
    out, pred, gt, d_inter, d_union = seen[-1]
    seg_hw = (CANVAS, CANVAS)
    grid = out["grid"]
    rounds = jfa_rounds_from_grid(grid, seg_hw).cpu()
    host = unwarp_argmax_scatter(out["pred"].float().cpu(), grid.cpu(), seg_hw, rounds=rounds)
    if not torch.equal(host, pred.cpu()):
        raise AssertionError("eval labels != host recompute through the plain jump flood")
    task_idx, valid = inverse_grid_index(grid.cpu(), seg_hw)
    yrev = unwarp_labels_fast(out["y_sampled"][..., None].cpu(), task_idx, valid, None,
                              rounds)[..., 0]
    if not torch.equal(yrev, out["y_sampled_reverse"].cpu()):
        raise AssertionError("eval y_sampled_reverse != host recompute through the plain versions")
    inter, union = M.intersection_and_union(host, gt.cpu(), 51)
    if not (torch.equal(inter, d_inter.cpu()) and torch.equal(union, d_union.cpu())):
        raise AssertionError("the card's per-class histograms != the host's")
    log(f"eval batch 3: labels and label round trip bit-equal to the host recompute "
        f"(rounds={int(rounds)}); per-class intersection and union equal the host's "
        f"({int(inter.sum())} / {int(union.sum())} pixels)")

    # host cost per sample of the boundary metrics, on that batch
    p_np, g_np = host.numpy(), gt.cpu().numpy()
    host_ms = {}
    for name, fn in (("dice", lambda b: M.binary_dice(p_np[b] != 50, g_np[b] != 50)),
                     ("hd95", lambda b: M.hd95(p_np[b] != 50, g_np[b] != 50)),
                     ("trimap", lambda b: [M.trimap_accuracy(p_np[b], g_np[b], 2 ** i)
                                           for i in range(6)])):
        t = time.perf_counter()
        for b in range(p_np.shape[0]):
            fn(b)
        host_ms[name] = (time.perf_counter() - t) * 1e3 / p_np.shape[0]
    log(f"host ms per 640x640 sample: {json.dumps(host_ms)} (trimap: 6 widths) on {card}")
    del seen, out, pred, gt

    # one b2 batch of each other inverse warp
    b2 = ["VAL.batch_size", "2", "VAL.y_sampled_reverse", "True"]
    configs = {"tri": ["MODEL.rev_deform_interp", "tri", "TPU.tri_exact", "True"],
               "BI": ["MODEL.rev_deform_interp", "BI"],
               "uniform_nearest": ["MODEL.uniform_sample", "nearest"],
               "uniform_BI": ["MODEL.uniform_sample", "BI"]}
    other_counts, other = dict.fromkeys(counters(), 0), {}
    for name, opts in configs.items():
        outs = []
        reset_counts()
        res = cli.main(EVAL_FLAGS + ckpt + ["--num-batches", "1"] + EVAL_OPTS + b2 + opts
                       + ["DIR", f"{out_dir}/{name}"],
                       on_batch=lambda out, pred, gt, acc: outs.append(out))
        n = read_counts()
        log(f"eval b2 {name}: {json.dumps({k: v for k, v in res.items() if k != 'per_class_iou'})}"
            f"; launches {json.dumps(n)}")
        if name in ("tri", "BI") and n["jfa_seed"] == 0:
            raise AssertionError(f"{name}: the seed flood (K4) was launched no time")
        check_result(f"eval b2 {name}", res, 1)
        other_counts = {k: other_counts[k] + n[k] for k in n}
        other[name] = res["mean_iou"]
        if name == "tri":
            tri_out = outs[0]
    valid = ~tri_out["unfilled_mask"].cpu().numpy()
    t = time.perf_counter()
    for v in valid:
        build_fill_plan(v)
    tri_plan_ms = (time.perf_counter() - t) * 1e3 / len(valid)
    ref = unwarp_prediction_tri(tri_out["pred"][:1].float().cpu(), tri_out["grid_inv"][:1].cpu(),
                                torch.from_numpy(valid[:1]))
    tri_err = float(abs(tri_out["pred_sampled"][:1].cpu().numpy() - ref).max())
    log(f"exact 'tri': card blend vs host oracle on one 640x640 frame, max abs err {tri_err:.3g}; "
        f"host plan {tri_plan_ms:.1f} ms per sample on {card}")
    if not tri_err <= 1e-5:
        raise AssertionError(f"exact 'tri' on the card differs from the host oracle by {tri_err}")
    seconds = time.perf_counter() - t_phase
    log(f"phase 3c took {seconds:.1f} s on {card}")
    del tri_out
    torch.cuda.empty_cache()
    return counts, other_counts, dict(eval_fps=fps, eval_timing=timing, host_ms_per_sample=host_ms,
                                      tri_plan_ms_per_sample=tri_plan_ms, tri_max_abs_err=tri_err,
                                      eval_result={k: v for k, v in result.items()
                                                   if k != "per_class_iou"},
                                      b2_mean_iou=other, phase_3c_s=seconds)


TRAIN_OPTS = ["TRAIN.task_input_size", "(80,80)", "TRAIN.saliency_input_size", "(80,80)",
              "MODEL.gaussian_radius", "45", "DATASET.num_class", "51",
              "TRAIN.batch_size_per_gpu", "8"]
TINY_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny"]


def train_cfg(*opts):
    """deform.yaml with ``opts`` (the flagship's by default)."""
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(list(opts) or TRAIN_OPTS)
    cfg.TRAIN.max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch
    return cfg


def check_k5b(device):
    """Phase 3d: K5b against its plain version at the flagship's inverse-warp
    indices (``tools/profile_gather.py::k5b_cases``: 'nearest' and 'BI' at
    C = 51, the two shapes ``MODEL.loss_at_high_res`` trains with, then C =
    1 at K2's output and 2 and 3 at K4's, which no path launches), on random
    f32 gradient rows: bit-equal (both sum each row in ascending pixel
    order) and the same bits over two launches, with times beside the atomic
    ``index_add_`` and the deterministic ``index_put_(accumulate=True)``
    (whose bits are checked for repeating)."""
    import torch

    from fovealseg_torch.ops.gather import row_gather_backward, row_gather_backward_plain
    from fovealseg_torch.tools.profile_gather import (device_ms, events_ms, k5b_bound_ms,
                                                      k5b_cases, k5b_libraries, loop_ms)

    cases = []
    for label, g, idx, t in k5b_cases(device, SEED + 21):
        c = g.shape[-1]
        first = row_gather_backward(g, idx, t)
        second = row_gather_backward(g, idx, t)
        ref = row_gather_backward_plain(g, idx, t)
        torch.cuda.synchronize()
        if not torch.equal(first.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"row_gather_backward kernel != plain on {label}: "
                                 f"{(first != ref).sum().item()} elements differ")
        if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
            raise AssertionError(f"row_gather_backward [{label}]: two launches differ")
        libs = k5b_libraries(g, idx, t)
        det = [libs["index_put_deterministic"]() for _ in range(2)]
        det_repeats = torch.equal(det[0].view(torch.int32), det[1].view(torch.int32))
        det_equal = torch.equal(det[0].view(torch.int32),
                                ref.reshape(det[0].shape).view(torch.int32))
        del first, second, ref, det

        def kernel():
            return row_gather_backward(g, idx, t)

        dev_ms, per_call, _ = device_ms(kernel, 20)
        per_call = round(per_call)  # the profiler drops a kernel event now and then
        r = dict(label=label, channels=c, max_abs_err=0.0, bit_equal=True,
                 ms=events_ms(kernel, 20), loop_ms=loop_ms(kernel, 20), device_ms=dev_ms,
                 kernels_per_call=per_call,
                 plain_ms=events_ms(lambda: row_gather_backward_plain(g, idx, t), 3, warmup=1),
                 bound_ms=k5b_bound_ms(g, t),
                 libraries={name: {"ms": events_ms(fn, 20), "device_ms": device_ms(fn, 20)[0]}
                            for name, fn in libs.items()},
                 index_put_deterministic_repeats=det_repeats,
                 index_put_deterministic_equals_k5b=det_equal)
        r["library_ms"] = r["libraries"]["index_add_"]["ms"]
        log(f"row_gather_backward [{label}]: bit-equal, two launches equal; kernel "
            f"{r['ms']:.4f} ms events, {r['loop_ms']:.4f} ms back to back, {dev_ms:.4f} ms "
            f"device ({per_call} launches per call); plain {r['plain_ms']:.4f} ms; "
            + "".join(f"{lib} {v['ms']:.4f} ms events, {v['device_ms']:.4f} ms device; "
                      for lib, v in r["libraries"].items())
            + f"index_put_ deterministic repeats: {det_repeats}, equals K5b: {det_equal}; "
            f"bound {r['bound_ms']:.4f} ms (bytes)")
        cases.append(r)
        del g, idx, libs
        torch.cuda.empty_cache()
    first = cases[0]  # 'nearest' C = 51
    return dict({k: first[k] for k in ("ms", "loop_ms", "device_ms", "plain_ms", "library_ms",
                                       "bound_ms", "libraries")},
                max_abs_err=0.0, bit_equal=True, launches_per_call=first["kernels_per_call"],
                cases=cases)


def _no_dropout(model):
    from fovealseg_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _group_grads(model):
    """{group: flat f32 gradient on the host} of the four sub-networks."""
    import torch

    from fovealseg_torch.train.optim import GROUPS

    out = {}
    for name, sub, _, _ in GROUPS:
        gs = [p.grad.detach().float().cpu().reshape(-1) for p in getattr(model, sub).parameters()
              if p.grad is not None]
        out[name] = torch.cat(gs) if gs else torch.zeros(0)
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def float64_nets(model):
    """A copy of ``model`` whose sub-networks hold f64 weights and compute in
    f64, the geometry between them (saliency to grid, warp, inverse warp,
    losses) in f32 as before: the float64 yardstick of the checks that hold
    the card to the host. The tiny nets' train-mode BN amplifies the last
    bits of their inputs, so the card's f32 distance from this yardstick is
    held to about twice the host's f32 distance, not to a fixed bound."""
    import copy

    import torch

    m = copy.deepcopy(model).double()
    for sub in m.modules():
        if hasattr(sub, "compute_dtype"):
            sub.compute_dtype = torch.float64
    return m


def _host_and_card_step(device, opts):
    """One train step of the tiny pair (same weights, dropout off) on the
    host, on the card and on the host with float64 sub-networks
    (:func:`float64_nets`) on one synthetic b2 batch: (host, card, host64)
    as (model, mets, grads, params before) each."""
    import numpy as np
    import torch

    from fovealseg_torch.data.synthetic import make_batch
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    cfg = train_cfg(*TINY_OPTS, *opts)
    over = {"loss_at_high_res": cfg.MODEL.loss_at_high_res,
            "rev_deform_interp": cfg.MODEL.rev_deform_interp}
    host, card = _tiny_pair(device, **over)
    batch = make_batch(np.random.default_rng(SEED + 22), 2, canvas=64)
    runs = []
    for model in (host, card, float64_nets(host)):
        _no_dropout(model)
        dev = next(model.parameters()).device
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state = S.init_state(model, create_optimizer(cfg, model), SEED)
        step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        # the step zeroes the gradients before its backward: run it, then read
        # the gradients it left behind
        mets = step(state, tb)
        runs.append((model, {k: float(v) for k, v in mets.items()}, _group_grads(model), before))
    return runs


def _update_of(model, before, sub) -> dict:
    """{'params' | 'stats': the f64 host copy of ``sub``'s update}."""
    import torch

    out = {"params": [], "stats": []}
    for k, v in model.state_dict().items():
        if k.startswith(sub + ".") and "num_batches" not in k:
            d = (v.detach().cpu().double() - before[k].cpu().double()).reshape(-1)
            out["stats" if "running_" in k else "params"].append(d)
    return {kind: torch.cat(ds) if ds else torch.zeros(0, dtype=torch.float64)
            for kind, ds in out.items()}


def check_small_train_against_host(device) -> dict:
    """One train step of the tiny pair, card (f32, TF32 off) against host,
    dropout off on both: the loss within 1e-4; each group's gradient within
    5% in norm (on the host alone, moving the warped image by 1.4e-5 of its
    scale moves the tiny encoder's train-mode gradients by 2.3%: its
    smallest BN branch normalises 8 values); BN statistics within 1e-3 of
    their update in norm; every updated parameter within 2.01 learning rates
    of the host's (Adam's first step moves every element by ~lr whatever its
    gradient's size, so an element whose gradient is at the noise level
    moves +lr on one device and -lr on the other). Each group's Adam update
    is held to the float64 yardstick (:func:`float64_nets`): its distance in
    norm from the host's float64 update at most twice the host f32 update's
    distance, a bound that must itself lie below the float64 update's norm
    (so a card that left a group unchanged fails).
    Then one ``MODEL.loss_at_high_res`` step in 'nearest' and in 'BI': the
    saliency nets' gradient (it reaches them only through the row gather's
    backward) must be non-zero and within 5% of the host's, and K5b must
    have run."""
    import torch

    from fovealseg_torch.ops import gather
    from fovealseg_torch.train.optim import GROUPS

    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        (h_model, h_mets, h_grads, h_before), (c_model, c_mets, c_grads, c_before), \
            (f_model, _, _, f_before) = _host_and_card_step(device, [])
        res = {"loss_host": h_mets["loss"], "loss_card": c_mets["loss"],
               "loss_rel_err": abs(c_mets["loss"] - h_mets["loss"]) / abs(h_mets["loss"])}
        res["grad_rel_err"] = {g: _rel(c_grads[g], h_grads[g]) for g in h_grads}
        stat_num = stat_den = max_dev = 0.0
        upd_err, yard = {}, {}
        for name, sub, _, _ in GROUPS:
            dh, dc = _update_of(h_model, h_before, sub), _update_of(c_model, c_before, sub)
            d64 = _update_of(f_model, f_before, sub)["params"]
            stat_num += float(((dc["stats"] - dh["stats"]) ** 2).sum())
            stat_den += float((dh["stats"] ** 2).sum())
            upd_err[name] = _rel(dc["params"], dh["params"])
            max_dev = max(max_dev, float((dc["params"] - dh["params"]).abs().max()))
            card64, host64 = float((dc["params"] - d64).norm()), float((dh["params"] - d64).norm())
            yard[name] = dict(card=card64, host=host64, bound=2 * host64,
                              norm=float(d64.norm()))
        res["update_rel_err"] = upd_err
        res["update_from_float64"] = yard
        res["bn_stat_rel_err"] = (stat_num / max(stat_den, 1e-300)) ** 0.5
        lr = 0.1 * train_cfg(*TINY_OPTS).TRAIN.lr_mult_encoder
        res["max_param_dev_over_lr"] = max_dev / lr
        log(f"tiny train step card vs host: {json.dumps(res)}")
        if (res["loss_rel_err"] > 1e-4 or max(res["grad_rel_err"].values()) > 0.05
                or res["bn_stat_rel_err"] > 1e-3 or res["max_param_dev_over_lr"] > 2.01):
            raise AssertionError("the tiny train step on the card disagrees with the host's")
        loose = {g: y for g, y in yard.items() if y["bound"] >= y["norm"]}
        if loose:
            raise AssertionError("the float64 yardstick cannot tell an unchanged group from "
                                 "the update (twice the host's distance >= the update's "
                                 f"norm): {loose}")
        far = {g: y for g, y in yard.items() if y["card"] > y["bound"]}
        if far:
            raise AssertionError("the card's Adam update is farther from the float64 step than "
                                 f"twice the host's distance: {far}")
        for interp in ("nearest", "BI"):
            before = gather.row_gather_backward.launches
            (_, h_mets, h_grads, _), (_, c_mets, c_grads, _), _ = _host_and_card_step(
                device, ["MODEL.loss_at_high_res", "True", "MODEL.rev_deform_interp", interp])
            launched = gather.row_gather_backward.launches - before
            sal = torch.cat([c_grads["saliency"], c_grads["compress"]])
            sal_h = torch.cat([h_grads["saliency"], h_grads["compress"]])
            r = {"loss_rel_err": abs(c_mets["loss"] - h_mets["loss"]) / abs(h_mets["loss"]),
                 "saliency_grad_norm": float(sal.norm()), "saliency_grad_rel_err": _rel(sal, sal_h),
                 "k5b_launches": launched}
            res[f"high_res_{interp}"] = r
            log(f"tiny loss_at_high_res '{interp}' step card vs host: {json.dumps(r)}")
            if (launched < 1 or not r["saliency_grad_norm"] > 0 or r["loss_rel_err"] > 1e-4
                    or r["saliency_grad_rel_err"] > 0.05):
                raise AssertionError(f"loss_at_high_res '{interp}' on the card: saliency "
                                     f"gradient lost or off the host's: {r}")
    finally:
        torch.backends.cudnn.conv.fp32_precision = prev
    return res


def _flagship_state(device, dtype, cfg):
    import torch

    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    over = {"loss_at_high_res": cfg.MODEL.loss_at_high_res,
            "rev_deform_interp": cfg.MODEL.rev_deform_interp,
            "arch_encoder": cfg.MODEL.arch_encoder, "fc_dim": cfg.MODEL.fc_dim,
            "saliency_net": cfg.MODEL.saliency_net}
    model = flagship(getattr(torch, dtype), device, **over)
    state = S.init_state(model, create_optimizer(cfg, model), SEED)
    return state, S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))


def _batches(device, n, seed):
    import torch

    from fovealseg_torch.data.synthetic import make_batch_device

    gen = torch.Generator(device=device).manual_seed(seed)
    return [make_batch_device(gen, 8, CANVAS, 50) for _ in range(n)]


def device_kernels(prof):
    """The kernels of a torch.profiler run: its CUDA events without the
    annotations (the optimizer's ``Optimizer.step#...`` range also appears on
    the device timeline, over the kernels it launched)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def time_train(card, device, dtype, cfg=None, steps=10, profiled=2, label="train b8") -> dict:
    """The default training step at b8 (the flagship's, or ``cfg``'s model): 2
    warm-up steps, ``steps`` timed (host clock, ending in a synchronise),
    then ``profiled`` under torch.profiler for the device-busy time and the
    kernels per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.train.loop import batch_controls

    cfg = cfg or train_cfg()
    state, step = _flagship_state(device, dtype, cfg)
    batches = _batches(device, 2, SEED + 23)
    losses = []

    def run(i):
        b = {**batches[i % 2], **batch_controls(cfg, 1, state.step, state.pool_rng)}
        losses.append(step(state, b)["loss"])

    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        run(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(profiled):
            run(i)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / profiled
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label} {dtype}: non-finite loss {losses}")
    top = {}
    for e in kernels:
        top[e.name[:50]] = top.get(e.name[:50], 0.0) + e.time_range.elapsed_us() / 1e3 / profiled
    res = dict(samples_per_s=8 / (step_ms / 1e3), step_ms=step_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / step_ms, kernels_per_step=len(kernels) / profiled,
               losses=losses, top_kernels_ms=dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{label} {dtype}: {res['samples_per_s']:.2f} samples/s ({step_ms:.2f} ms/step host "
        f"clock), device busy {busy_ms:.2f} ms/step, idle share {res['idle_share']:.3f}, "
        f"{res['kernels_per_step']:.0f} kernels/step; losses {losses} on {card}")
    log(f"{label} {dtype} top kernels (ms/step): {json.dumps(res['top_kernels_ms'])}")
    del state, batches
    torch.cuda.empty_cache()
    return res


def profile_high_res_step(run) -> dict:
    """One step on the host clock, then one under torch.profiler: device-busy
    ms, kernels, and the device ms of the jump floods, K5 and K5b (all its
    launches, the zero fill of its table included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)

    def ms(*names):
        return sum(e.time_range.elapsed_us() for e in kernels
                   if any(n in e.name for n in names)) / 1e3

    busy = ms("")
    return {"profile": dict(step_ms=wall, device_busy_ms=busy, idle_share=1.0 - busy / wall,
                            kernels=len(kernels), jfa_ms=ms("jfa_"),
                            k5_ms=ms("gather_small", "gather_wide", "gather_scalar"),
                            k5b_ms=ms("k5b_"))}


def train_high_res(device) -> tuple[dict, dict]:
    """The flagship with ``MODEL.loss_at_high_res`` at b8, float32: 2 steps in
    'nearest' (K2, K5 and K5b once each per step), 1 in 'BI' (K4, K5, K5b)."""
    import torch

    from fovealseg_torch.train.loop import batch_controls

    counts_all = dict.fromkeys(counters(), 0)
    res = {}
    for interp, steps, expected in (("nearest", 2, {"jfa_relpay": 1, "row_gather": 1,
                                                     "row_gather_backward": 1}),
                                    ("BI", 1, {"jfa_seed": 1, "row_gather": 1,
                                               "row_gather_backward": 1})):
        cfg = train_cfg(*TRAIN_OPTS, "MODEL.loss_at_high_res", "True",
                        "MODEL.rev_deform_interp", interp)
        state, step = _flagship_state(device, "float32", cfg)
        batches = _batches(device, steps, SEED + 24)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        losses = [step(state, {**b, **batch_controls(cfg, 1, state.step, state.pool_rng)})["loss"]
                  for b in batches]
        counts = read_counts()
        ms = (time.perf_counter() - t) * 1e3 / steps
        check_counts(f"loss_at_high_res '{interp}' ({steps} b8 steps)", counts,
                     {**dict.fromkeys(counts, 0), **{k: v * steps for k, v in expected.items()}})
        losses = [float(v) for v in losses]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"loss_at_high_res '{interp}': non-finite loss {losses}")
        res[interp] = dict(step_ms=ms, losses=losses, **profile_high_res_step(
            lambda: step(state, {**batches[0], **batch_controls(cfg, 1, state.step,
                                                                 state.pool_rng)})))
        log(f"train b8 f32 loss_at_high_res '{interp}': {ms:.2f} ms/step (first steps, host "
            f"clock), losses {losses}; one more step profiled: {json.dumps(res[interp]['profile'])}")
        counts_all = {k: counts_all[k] + counts[k] for k in counts}
        del state, batches
        torch.cuda.empty_cache()
    return res, counts_all


def train_cli(out_dir) -> tuple[dict, dict]:
    """The train CLI on the flagship: 2 epochs x 3 iterations, then one more
    epoch resumed from ``epoch_last``; the eval CLI on the epoch-3
    checkpoint."""
    import csv
    import os

    from fovealseg_torch.cli import eval as ecli
    from fovealseg_torch.cli import train as tcli

    d = f"{out_dir}/train"
    base = ["--cfg", "fovealseg_torch/configs/deform.yaml", *TRAIN_OPTS, "TRAIN.epoch_iters", "3",
            "DIR", d]
    reset_counts()
    t = time.perf_counter()
    state = tcli.main(base + ["TRAIN.num_epoch", "2"])
    first_s = time.perf_counter() - t
    if state.step != 6:
        raise AssertionError(f"train CLI: step {state.step} after 2 epochs of 3, expected 6")
    with open(os.path.join(d, "history_epoch_last_0.csv")) as fh:
        cols = next(csv.reader(fh))
    if cols != ["epoch", "train_loss", "train_acc", "train_edge_loss"]:
        raise AssertionError(f"history CSV columns {cols}")
    t = time.perf_counter()
    state = tcli.main(base + ["TRAIN.num_epoch", "3", "TRAIN.auto_resume", "True"])
    resume_s = time.perf_counter() - t
    if state.step != 9:
        raise AssertionError(f"train CLI resumed: step {state.step}, expected 9")
    with open(os.path.join(d, "history_epoch_last_0.csv")) as fh:
        rows = list(csv.DictReader(fh))
    if len(rows) != 9 or float(rows[-1]["epoch"]) != 3.0:
        raise AssertionError(f"resumed history: {len(rows)} rows, last epoch {rows[-1]['epoch']}")
    files = sorted(os.listdir(d))
    for kind in ("saliency", "compress", "encoder", "decoder", "train_state"):
        for tag in (2, 3, "last"):
            if f"{kind}_epoch_{tag}.pth" not in files:
                raise AssertionError(f"train CLI did not write {kind}_epoch_{tag}.pth: {files}")
    del state
    result = ecli.main(EVAL_FLAGS + ["--num-batches", "1", *EVAL_OPTS, "VAL.batch_size", "8",
                                     "VAL.y_sampled_reverse", "True", "TRAIN.start_epoch", "3",
                                     "DIR", d])
    check_result("eval of the trained epoch-3 checkpoint", result, 1)
    counts = read_counts()
    res = dict(two_epochs_s=first_s, resume_epoch_s=resume_s, history_rows=len(rows),
               eval_mean_iou=result["mean_iou"], eval_pixel_acc=result["pixel_acc"])
    log(f"train CLI: 2 epochs x 3 b8 iterations (+ 2 evals of 8 b8 batches) in {first_s:.1f} s, "
        f"resumed epoch 3 in {resume_s:.1f} s (step 9); eval of epoch 3: "
        f"{json.dumps({k: v for k, v in result.items() if k != 'per_class_iou'})}")
    return res, counts


def _load_tag(d, tag) -> dict:
    import torch

    from fovealseg_torch.train import checkpoint as ckpt

    return {kind: torch.load(f"{d}/{kind}_epoch_{tag}.pth", map_location="cpu", weights_only=True)
            for kind in (*ckpt.SUBMODULE_OF_FILE, "train_state")}


def _bit_equal_trees(a, b, where="") -> int:
    """Nested dicts, lists and tensors equal bit for bit; returns the tensors
    compared."""
    import torch

    if torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)):
            raise AssertionError(f"checkpoint files differ at {where}")
        return 1
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"checkpoint files differ at {where}: keys")
        return sum(_bit_equal_trees(a[k], b[k], f"{where}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"checkpoint files differ at {where}: lengths")
        return sum(_bit_equal_trees(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    if a != b:
        raise AssertionError(f"checkpoint files differ at {where}: {a!r} != {b!r}")
    return 0


def checkpoint_write(card, device, out_dir) -> dict:
    """Phase 3d: the checkpoint write of the flagship's b8 f32 state with
    Adam (``train/checkpoint.py``), on a cadence epoch (the numbered tag and
    the ``_last`` copies), synchronous and with ``AsyncSaver`` in turn, two
    epochs each: the seconds the training thread blocks in
    ``save_checkpoint``; for the saver, one training step run while the
    write is in flight, the seconds until the write drains (from the save's
    start) and the writer thread's own seconds; the bytes written. The two
    writes of an epoch (the same state) load to bit-equal tensors."""
    import os
    import shutil

    import torch

    from fovealseg_torch.train import checkpoint as ckpt
    from fovealseg_torch.train.loop import batch_controls

    cfg = train_cfg()
    state, step = _flagship_state(device, "float32", cfg)
    batches = _batches(device, 1, SEED + 25)

    def train_step():
        step(state, {**batches[0], **batch_controls(cfg, 1, state.step, state.pool_rng)})

    def tag_bytes(d, tags):
        return sum(os.path.getsize(p) for t in tags for p in ckpt._tag_paths(d, t).values())

    dirs = {"sync": f"{out_dir}/ckpt_sync", "async": f"{out_dir}/ckpt_async"}
    saver = ckpt.AsyncSaver()
    res = {"sync": [], "async": []}
    train_step()
    for epoch in (1, 2):
        train_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save_checkpoint(dirs["sync"], epoch, state)
        res["sync"].append(dict(block_s=time.perf_counter() - t,
                                bytes=tag_bytes(dirs["sync"], (epoch, "last"))))
        t = time.perf_counter()
        ckpt.save_checkpoint(dirs["async"], epoch, state, saver=saver)
        block = time.perf_counter() - t
        train_step()  # the next epoch's first step, while the write is in flight
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t - block
        saver.wait()
        res["async"].append(dict(block_s=block, step_during_write_s=step_s, drain_s=time.perf_counter() - t,
                                 write_s=saver.last_write_s, bytes=saver.last_bytes))
        tensors = sum(_bit_equal_trees(_load_tag(dirs["sync"], tag), _load_tag(dirs["async"], tag),
                                       f"epoch {epoch} tag {tag}") for tag in (epoch, "last"))
        res["async"][-1]["tensors_bit_equal"] = tensors
        for d in dirs.values():  # keep the disk to one epoch's files
            for path in ckpt._tag_paths(d, epoch).values():
                os.remove(path)
        log(f"checkpoint write, epoch {epoch} (tag {epoch} + _last): sync "
            f"{json.dumps(res['sync'][-1])}; async {json.dumps(res['async'][-1])}; the two "
            f"sets bit-equal ({tensors} tensors) on {card}")
    saver.close()
    for d in dirs.values():
        shutil.rmtree(d)
    del state, batches
    torch.cuda.empty_cache()
    return res


def train_path(card, device, out_dir):
    """Phase 3d."""
    t = time.perf_counter()
    numbers = {"row_gather_backward": check_k5b(device)}
    small = check_small_train_against_host(device)
    reset_counts()
    timing = {dt: time_train(card, device, dt) for dt in ("float32", "bfloat16")}
    default_counts = read_counts()
    check_counts("the default training step (24 b8 steps)", default_counts,
                 dict.fromkeys(default_counts, 0))
    high_res, high_res_counts = train_high_res(device)
    cli_res, cli_counts = train_cli(out_dir)
    counts = {k: high_res_counts[k] + cli_counts[k] for k in high_res_counts}
    reset_counts()
    ckpt_res = checkpoint_write(card, device, out_dir)
    check_counts("the checkpoint write", read_counts(), dict.fromkeys(counts, 0))
    seconds = time.perf_counter() - t
    log(f"phase 3d took {seconds:.1f} s on {card}")
    return numbers, counts, dict(small_train=small, train=timing, train_high_res=high_res,
                                 train_cli=cli_res, checkpoint_write=ckpt_res, phase_3d_s=seconds)


# --------------------------------------------------------------- phase 3e

ENCODERS = {"segformer": ("segformer", 1024), "deeplab": ("deeplab", 960)}
ZOOM_NETS = ("resnet18", "resnet18_nonsyn", "resnet18_stride1", "resnet10_nonsyn")
# the wrappers that the inverse warp calls (``core/unwarp.py``), by counter name
UNWARP_KERNELS = {"jfa_class": "nearest_class", "jfa_relpay": "nearest_payload_packed",
                  "row_gather": "row_gather"}


@contextlib.contextmanager
def kernel_inputs(kernels=None):
    """Copies of the inputs of the last call of each kernel wrapper on a path
    ({counter name: args}), taken on the way in: K1, K2 and K5 (or
    ``kernels``, {counter name: ``core/unwarp.py``'s name of the wrapper})
    where ``core/unwarp.py`` calls them, K5b where ``RowGather.backward``
    does."""
    import torch

    from fovealseg_torch.core import unwarp
    from fovealseg_torch.ops import gather

    seen = {}

    def recording(name, fn):
        def call(*args):
            seen[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return fn(*args)
        return call

    kernels = kernels or UNWARP_KERNELS
    saved = {attr: getattr(unwarp, attr) for attr in kernels.values()}
    backward = gather.RowGather.backward

    def copy_backward(ctx, grad_out):
        seen["row_gather_backward"] = (grad_out.detach().contiguous().clone(),
                                       ctx.saved_tensors[0].clone(), ctx.rows)
        return backward(ctx, grad_out)

    try:
        for name, attr in kernels.items():
            setattr(unwarp, attr, recording(name, saved[attr]))
        gather.RowGather.backward = staticmethod(copy_backward)
        yield seen
    finally:
        for attr, fn in saved.items():
            setattr(unwarp, attr, fn)
        gather.RowGather.backward = staticmethod(backward)


def hold_on_path_inputs(label, seen, names):
    """Each kernel in ``names`` on the inputs it was given on the path,
    against its plain version on the same inputs: bit-equal. Run after the
    path's counts are read (these launches are not the path's)."""
    import torch

    from fovealseg_torch.ops import gather, jfa

    pairs = {"jfa_class": (jfa.nearest_class, jfa.nearest_class_plain),
             "jfa_relpay": (jfa.nearest_payload_packed, jfa.nearest_payload_packed_plain),
             "jfa_seed": (jfa.nearest_seed, jfa.nearest_seed_plain),
             "row_gather": (gather.row_gather, gather.row_gather_plain),
             "row_gather_backward": (gather.row_gather_backward,
                                     gather.row_gather_backward_plain)}
    shapes = {}
    for name in names:
        if name not in seen:
            raise AssertionError(f"{label}: {name} was not called on the path")
        kernel, plain = pairs[name]
        args = seen[name]
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        bits = torch.int32 if got.element_size() == 4 else got.dtype
        if got.shape != ref.shape or not torch.equal(got.view(bits), ref.view(bits)):
            raise AssertionError(f"{name} kernel != plain on {label}'s own inputs")
        shapes[name] = list(args[0].shape)
    log(f"{label}: {', '.join(f'{n} {shapes[n]}' for n in names)} bit-equal to the plain "
        f"versions on the path's own inputs")
    return shapes


def serve_encoder(card, device, name, models):
    """Phase 3e serving of one encoder: argmax labels and score maps through
    ``infer`` at b8 and b1 in f32 and bf16 (CUDA events and host clock), then
    each cell under torch.profiler; counts read just after each path, and
    the path's K1 (argmax) or K2 and K5 (score map) held on its own inputs."""
    from fovealseg_torch.tools.profile_serving import profile_cell

    res, counts_by_path = {}, {}
    for path, kw, kernels in (("argmax", dict(argmax_labels=True), ("jfa_class",)),
                              ("scoremap", dict(argmax_labels=False),
                               ("jfa_relpay", "row_gather"))):
        reset_counts()
        calls, cells = 0, {}
        with kernel_inputs() as seen:
            for dt, model in models.items():
                tm, n = time_infer(model, device, n8=5, n1=6, **kw)
                calls += n
                for b in (8, 1):
                    prof = profile_cell(model, b, 1, argmax_labels=kw["argmax_labels"])
                    calls += 3 + 2 * 1
                    cells[f"b{b} {dt}"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                                 "idle_share",
                                                                 "kernels_per_call")}
                tm["cells"] = {k: v for k, v in cells.items() if k.endswith(dt)}
                res[f"{path} {dt}"] = tm
                log(f"{name} {path} {dt}: b8 {tm['b8_ms']:.3f} ms = {tm['b8_fps']:.1f} fps, b1 "
                    f"{tm['b1_ms']:.3f} ms (events), {tm['b1_host_ms']:.3f} ms (host clock); "
                    f"profiled {json.dumps(tm['cells'])} on {card}")
            # the last call, whose kernel inputs are held below: b8 float32
            models["float32"].infer(*frames(8, CANVAS, SEED + 32, device), **kw)
            calls += 1
        counts = read_counts()
        check_counts(f"{name} {path}", counts,
                     {**dict.fromkeys(counts, 0), **dict.fromkeys(kernels, calls)})
        hold_on_path_inputs(f"{name} {path}", seen, kernels)
        counts_by_path[f"{name}_{path}"] = counts
    return res, counts_by_path


def eval_encoder(card, device, name, model16, out_dir):
    """Phase 3e: one b8 bf16 batch of the eval CLI with the encoder (label
    round trip on), on ``model16``'s weights (``eval_checkpoint``); K1, K2
    and K5 held on the batch's own inputs."""
    from fovealseg_torch.cli import eval as cli

    arch, fc_dim = ENCODERS[name]
    eval_checkpoint(model16, device, f"{out_dir}/ckpt")
    reset_counts()
    with kernel_inputs() as seen:
        result = cli.main(EVAL_FLAGS + ["--torch-ckpt", f"{out_dir}/ckpt", "--torch-epoch", "0",
                                        "--num-batches", "1"] + EVAL_OPTS
                          + ["VAL.batch_size", "8", "VAL.y_sampled_reverse", "True",
                             "MODEL.arch_encoder", arch, "MODEL.fc_dim", str(fc_dim),
                             "DIR", f"{out_dir}/eval"])
    counts = read_counts()
    check_counts(f"{name} eval (1 b8 batch)", counts,
                 {**dict.fromkeys(counts, 0), "jfa_class": 1, "jfa_relpay": 1, "row_gather": 1})
    check_result(f"{name} eval b8", result, 1)
    log(f"{name} eval b8 bf16: {json.dumps({k: v for k, v in result.items() if k != 'per_class_iou'})}"
        f" on {card}")
    hold_on_path_inputs(f"{name} eval", seen, ("jfa_class", "jfa_relpay", "row_gather"))
    return {k: v for k, v in result.items() if k != "per_class_iou"}, counts


def train_encoder(card, device, name):
    """Phase 3e: the default train step at b8 in f32 and bf16 (no kernel of
    ours runs), then one ``MODEL.loss_at_high_res`` 'nearest' step at b8 f32
    (K2, K5 and K5b once each, held on the step's own inputs) and one more
    under torch.profiler."""
    import torch

    from fovealseg_torch.train.loop import batch_controls

    arch, fc_dim = ENCODERS[name]
    opts = (*TRAIN_OPTS, "MODEL.arch_encoder", arch, "MODEL.fc_dim", str(fc_dim))
    reset_counts()
    res = {dt: time_train(card, device, dt, cfg=train_cfg(*opts), steps=3, profiled=1,
                          label=f"{name} train b8") for dt in ("float32", "bfloat16")}
    counts = read_counts()
    check_counts(f"{name} default train steps", counts, dict.fromkeys(counts, 0))
    cfg = train_cfg(*opts, "MODEL.loss_at_high_res", "True", "MODEL.rev_deform_interp", "nearest")
    state, step = _flagship_state(device, "float32", cfg)
    (batch,) = _batches(device, 1, SEED + 25)
    torch.cuda.synchronize()
    reset_counts()
    with kernel_inputs() as seen:
        loss = float(step(state, {**batch, **batch_controls(cfg, 1, state.step,
                                                            state.pool_rng)})["loss"])
    hr_counts = read_counts()
    kernels = ("jfa_relpay", "row_gather", "row_gather_backward")
    check_counts(f"{name} loss_at_high_res 'nearest' (1 b8 step)", hr_counts,
                 {**dict.fromkeys(hr_counts, 0), **dict.fromkeys(kernels, 1)})
    if not math.isfinite(loss):
        raise AssertionError(f"{name} loss_at_high_res: non-finite loss {loss}")
    hold_on_path_inputs(f"{name} loss_at_high_res step", seen, kernels)
    del seen
    prof = profile_high_res_step(lambda: step(state, {**batch, **batch_controls(
        cfg, 1, state.step, state.pool_rng)}))
    res["high_res_nearest"] = dict(loss=loss, **prof)
    log(f"{name} train b8 f32 loss_at_high_res 'nearest': loss {loss:.4f}; one more step "
        f"profiled: {json.dumps(prof['profile'])} on {card}")
    del state, step, batch
    torch.cuda.empty_cache()
    return res, {"train": counts, "train_high_res": hr_counts}


TINY_MIT = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), strides=(1, 2, 2, 2),
                patch_sizes=(7, 3, 3, 3), num_heads=(1, 2, 3, 4), sr_ratios=(8, 4, 2, 1),
                mlp_ratio=4)


def check_tiny_encoders_against_host(device) -> dict:
    """Each new encoder and saliency net at a cut depth (SegFormer 1/1/1/1
    blocks at widths 8-32, DeepLab one Bottleneck per layer, the ResNetZoom
    nets whole), the same seeded weights on the card (TF32 off) and on the
    host, eval and train mode (dropout and drop path off): the output within
    1e-4 of its largest magnitude (the CPU tests hold the port to the JAX
    package within 1e-5), and BN's running statistics after the train-mode
    forward within 1e-4."""
    import copy

    import numpy as np
    import torch

    from fovealseg_torch.models.deeplab import DeepLabEncoder
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.models.saliency import ResNetZoom
    from fovealseg_torch.models.saliency import ZOOM_NETS as ZOOM
    from fovealseg_torch.models.segformer import SegFormerEncoder

    nets = {"segformer": (lambda: SegFormerEncoder(TINY_MIT, drop_path_rate=0.0), 3, 16, 2),
            "deeplab": (lambda: DeepLabEncoder(layers=(1, 1, 1, 1)), 3, 32, 2),
            **{n: (lambda n=n: ResNetZoom(*ZOOM[n]), 5, 16 if n.endswith("stride1") else 32, 3)
               for n in ZOOM_NETS}}
    res = {}
    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        for name, (make, cin, hw, batch) in nets.items():
            host = _no_dropout(init_weights(make(), torch.Generator().manual_seed(SEED)))
            x = torch.from_numpy(np.random.default_rng(SEED + 30).normal(
                size=(batch, cin, hw, hw)).astype(np.float32))
            for train in (False, True):
                h, c = copy.deepcopy(host), copy.deepcopy(host).to(device)
                h.train(train), c.train(train)
                with torch.no_grad():
                    ref, got = h(x), c(x.to(device))
                ref = ref[0] if isinstance(ref, list) else ref
                got = (got[0] if isinstance(got, list) else got).cpu()
                err = float((got - ref).abs().max() / ref.abs().max())
                stat = max([float((c.state_dict()[k].cpu() - v).abs().max()
                                  / v.abs().max().clamp(min=1e-30))
                            for k, v in h.state_dict().items() if "running_" in k] or [0.0])
                res[f"{name} {'train' if train else 'eval'}"] = dict(rel_err=err, bn_stat_err=stat)
                if not (err <= 1e-4 and stat <= 1e-4):
                    raise AssertionError(f"tiny {name} on the card differs from the host: "
                                         f"{err:.3g} (output), {stat:.3g} (BN statistics)")
    finally:
        torch.backends.cudnn.conv.fp32_precision = prev
    log(f"tiny encoders and saliency nets card vs host (TF32 off): {json.dumps(res)}")
    return res


def serve_zoom(card, device, name):
    """Phase 3e: the flagship HRNet with the ResNetZoom saliency ``name`` at
    b8 float32: argmax labels and score maps through ``infer`` (events), one
    argmax cell under torch.profiler, K1 / K2 and K5 held on the path's own
    inputs."""
    import torch

    from fovealseg_torch.tools.profile_gather import events_ms
    from fovealseg_torch.tools.profile_serving import profile_cell

    model = flagship(torch.float32, device, saliency_net=name)
    x, f = frames(8, CANVAS, SEED + 31, device)
    res = {"saliency_params": sum(p.numel() for p in model.localization.parameters())}
    counts_by_path = {}
    for path, am, kernels in (("argmax", True, ("jfa_class",)),
                              ("scoremap", False, ("jfa_relpay", "row_gather"))):
        reset_counts()
        with kernel_inputs() as seen:
            ms = events_ms(lambda: model.infer(x, f, argmax_labels=am), 5, warmup=2)
            calls = 7
            if am:
                prof = profile_cell(model, 8, 1, argmax_labels=True)
                calls += 5
                res["argmax_b8_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                                 "idle_share", "kernels_per_call")}
        counts = read_counts()
        check_counts(f"HRNet + {name} {path}", counts,
                     {**dict.fromkeys(counts, 0), **dict.fromkeys(kernels, calls)})
        hold_on_path_inputs(f"HRNet + {name} {path}", seen, kernels)
        res[f"{path}_b8_ms"] = ms
        res[f"{path}_b8_fps"] = 8 / (ms / 1e3)
        counts_by_path[f"zoom_{name}_{path}"] = counts
    out = model.infer(x, f, argmax_labels=True)
    labels = out["pred_label"]
    if labels.shape != (8, CANVAS, CANVAS) or not 0 <= int(labels.min()) <= int(labels.max()) < 51:
        raise AssertionError(f"HRNet + {name}: labels {tuple(labels.shape)} out of range")
    if not torch.isfinite(out["xs"]).all():
        raise AssertionError(f"HRNet + {name}: non-finite saliency")
    log(f"HRNet + {name} b8 f32: argmax {res['argmax_b8_fps']:.1f} fps, score map "
        f"{res['scoremap_b8_fps']:.1f} fps (events); argmax profiled "
        f"{json.dumps(res['argmax_b8_profile'])}; saliency net {res['saliency_params']} params "
        f"on {card}")
    del model, out
    torch.cuda.empty_cache()
    return res, counts_by_path


def encoders_path(card, device, out_dir):
    """Phase 3e."""
    import torch

    t_phase = time.perf_counter()
    res, counts_by_path = {}, {}
    for name, (arch, fc_dim) in ENCODERS.items():
        t = time.perf_counter()
        models = {dt: flagship(getattr(torch, dt), device, arch_encoder=arch, fc_dim=fc_dim)
                  for dt in ("float32", "bfloat16")}
        params = sum(p.numel() for p in models["float32"].parameters())
        enc_params = sum(p.numel() for p in models["float32"].encoder.parameters())
        log(f"== {name}: {params / 1e6:.2f} M parameters ({enc_params / 1e6:.2f} M in the "
            f"encoder), built in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        serving, c = serve_encoder(card, device, name, models)
        counts_by_path.update(c)
        log(f"{name} serving took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        evaluation, c = eval_encoder(card, device, name, models["bfloat16"],
                                     f"{out_dir}/{name}")
        counts_by_path[f"{name}_eval"] = c
        del models
        torch.cuda.empty_cache()
        log(f"{name} eval took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        training, c = train_encoder(card, device, name)
        counts_by_path.update({f"{name}_{k}": v for k, v in c.items()})
        log(f"{name} training took {time.perf_counter() - t:.1f} s")
        res[name] = dict(params=params, encoder_params=enc_params, serving=serving,
                         eval=evaluation, train=training)
    t = time.perf_counter()
    for name in ZOOM_NETS:
        res[f"zoom_{name}"], c = serve_zoom(card, device, name)
        counts_by_path.update(c)
    log(f"the ResNetZoom nets took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    res["tiny_against_host"] = check_tiny_encoders_against_host(device)
    log(f"the tiny card-vs-host checks took {time.perf_counter() - t:.1f} s")
    res["phase_3e_s"] = time.perf_counter() - t_phase
    log(f"phase 3e took {res['phase_3e_s']:.1f} s on {card}")
    return res, counts_by_path


# --------------------------------------------------------------- phase 3f

DP_HIGH_RES = ("MODEL.loss_at_high_res", "True", "MODEL.rev_deform_interp", "nearest")
# timed steps of each kind in (d), taken in turn
DP_TIMED_STEPS = 6


def _bits(t):
    import torch

    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _mismatch(a: dict, b: dict) -> dict:
    """Elements of two state dicts that differ bit for bit, and the largest
    absolute difference."""
    n = 0
    worst = 0.0
    for k, t in a.items():
        u = b[k]
        n += int((_bits(t) != _bits(u)).sum())
        if t.is_floating_point():
            worst = max(worst, float((t.double() - u.double()).abs().max()))
    return {"mismatched_elements": n, "max_abs_diff": worst}


def _interleaved_step_times(cfg, runs: dict, batches, n) -> dict:
    """The steps of ``runs`` ({name: (state, step)}) taken in turn, one of
    each, ``n`` times after one warm-up each, every step on the host clock
    ending in a synchronise, so that a drift of the shared host's load
    falls on all of them alike. Per name: the median ms per step, its
    quartiles, samples/s at the median; then one step each under
    torch.profiler: device-busy ms, idle share against the median, kernels
    per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.train.loop import batch_controls

    def run(name, i):
        state, step = runs[name]
        return step(state, {**batches[i % len(batches)],
                            **batch_controls(cfg, 1, state.step, state.pool_rng)})

    ms = {name: [] for name in runs}
    for i in range(n + 1):
        for name in runs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(name, i)
            torch.cuda.synchronize()
            if i:
                ms[name].append((time.perf_counter() - t) * 1e3)
    b = batches[0]["img_data"].shape[0]
    out = {}
    for name, ts in ms.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        # device activity only: the host events of ~13,000 kernels cost seconds to collect
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(name, 0)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        out[name] = dict(step_ms_median=med, step_ms_q1=q1, step_ms_q3=q3,
                         samples_per_s=b / (med / 1e3), steps=n, device_busy_ms=busy,
                         idle_share=1.0 - busy / med, kernels_per_step=len(kernels))
    return out


def dp_world_one(rank):
    """Phase 3f (a) and (d), in one NCCL rank: the flagship at b8 f32 with
    deterministic cuDNN, one default step and one ``loss_at_high_res``
    'nearest' step each through the single-process ``make_train_step`` and
    with the one-rank group (DDP), from
    the same weights and batch (dropout on: rank 0 keeps the stream); the
    loss, the updated parameters and the BN statistics compared bit for bit.
    The DP 'nearest' step's counts are read just after it, and its K2, K5
    and K5b held on their own inputs. Then both default steps timed in turn
    (:func:`_interleaved_step_times`, nothing else of the smoke running on
    the host)."""
    import os
    import warnings

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist

    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.loop import batch_controls
    from fovealseg_torch.train.optim import make_stage_schedules

    device = rank.device
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"counts": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for label, opts, kernels in (("default", (), ()),
                                     ("nearest", DP_HIGH_RES,
                                      ("jfa_relpay", "row_gather", "row_gather_backward"))):
            cfg = train_cfg(*TRAIN_OPTS, *opts)
            batches = _batches(device, 2, SEED + 40)
            states, steps, mets = {}, {}, {}
            for name, group in (("plain", None), ("dp", dist.group.WORLD)):
                states[name], _ = _flagship_state(device, "float32", cfg)
                steps[name] = S.make_train_step(S.LossConfig.from_cfg(cfg),
                                                make_stage_schedules(cfg), group=group)
                b = {**batches[0], **batch_controls(cfg, 1, 0, states[name].pool_rng)}
                torch.cuda.synchronize()
                reset_counts()
                with kernel_inputs() as seen:
                    m = steps[name](states[name], b)
                counts = read_counts()
                mets[name] = {k: float(v) for k, v in m.items()}
                if name == "dp":
                    check_counts(f"world-1 DDP step '{label}' (1 b8 step)", counts,
                                 {**dict.fromkeys(counts, 0), **dict.fromkeys(kernels, 1)})
                    out["counts"][label] = counts
                    if kernels:
                        hold_on_path_inputs(f"world-1 DDP '{label}' step", seen, kernels)
                del seen
            r = _mismatch({k: v.detach() for k, v in states["plain"].model.state_dict().items()},
                          {k: v.detach() for k, v in states["dp"].model.state_dict().items()})
            r.update(loss_plain=mets["plain"]["loss"], loss_dp=mets["dp"]["loss"],
                     metrics_equal=mets["plain"] == mets["dp"])
            log(f"world-1 DDP (NCCL) vs single-process step, '{label}' b8 f32: {json.dumps(r)} "
                f"({time.perf_counter() - t0:.1f} s into the rank)")
            out[label] = r
            if label == "default":
                out["times"] = _interleaved_step_times(
                    cfg, {name: (states[name], steps[name]) for name in states}, batches,
                    DP_TIMED_STEPS)
                log(f"timed at {time.perf_counter() - t0:.1f} s into the rank")
            del states, steps, batches
            torch.cuda.empty_cache()
    out["nondeterministic_ops"] = sorted({str(w.message)[:160] for w in caught
                                          if "deterministic" in str(w.message)})
    return out


def _tiny_dp_step(rank, batch, float64: bool) -> dict:
    """One data-parallel step of the tiny pair (cross-rank BN on, dropout
    off) on this rank's block of the global ``batch``; f64 sub-networks with
    ``float64``. Returns the loss and, on rank 0, each group's gradient."""
    import torch
    import torch.distributed as dist

    from fovealseg_torch.models.layers import convert_sync_bn
    from fovealseg_torch.parallel.mesh import replicate_state, shard_batch
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    cfg = train_cfg(*TINY_OPTS)
    host, _ = _tiny_pair("cpu")
    model = _no_dropout(float64_nets(host) if float64 else host).to(rank.device)
    convert_sync_bn(model, dist.group.WORLD)
    state = replicate_state(S.init_state(model, create_optimizer(cfg, model), SEED))
    step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg),
                             group=dist.group.WORLD)
    blk = shard_batch({k: torch.from_numpy(v).to(rank.device) for k, v in batch.items()},
                      rank.rank, rank.world_size)
    loss = float(step(state, blk)["loss"])
    grads = _group_grads(model) if rank.rank == 0 else None
    return {"loss": loss, "grads": grads}


def dp_tiny_host(rank, batch):
    """Phase 3f (b)'s host reference: the tiny two-rank gloo step in f32 and
    with f64 sub-networks."""
    import torch

    torch.set_num_threads(2)
    return {"f32": _tiny_dp_step(rank, batch, False), "f64": _tiny_dp_step(rank, batch, True)}


def dp_two_ranks_one_card(rank, batch):
    """Phase 3f (b), two gloo ranks on the one card: the flagship at a global
    b8 (4 per rank) in f32 with cross-rank BN, one step; every parameter and
    BN statistic compared with rank 0's bit for bit. Then the tiny two-rank
    step (TF32 off) for the float64 yardstick."""
    import torch
    import torch.distributed as dist

    from fovealseg_torch.models.layers import convert_sync_bn
    from fovealseg_torch.parallel.mesh import broadcast_tensors, replicate_state, shard_batch
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.loop import batch_controls
    from fovealseg_torch.train.optim import make_stage_schedules

    cfg = train_cfg()
    state, _ = _flagship_state(rank.device, "float32", cfg)
    synced = convert_sync_bn(state.model, dist.group.WORLD)
    replicate_state(state)
    step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg),
                             group=dist.group.WORLD)
    (full,) = _batches(rank.device, 1, SEED + 41)
    blk = shard_batch({**full, **batch_controls(cfg, 1, 0, state.pool_rng)}, rank.rank,
                      rank.world_size)
    loss = float(step(state, blk)["loss"])
    mine = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    first = {k: v.clone() for k, v in mine.items()}
    broadcast_tensors(list(first.values()))
    res = {"loss": loss, "bn_layers_synced": synced, "tensors": len(mine),
           "elements": sum(t.numel() for t in mine.values()), **_mismatch(mine, first)}
    del state, step, full, blk, mine, first
    torch.cuda.empty_cache()
    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        res["tiny"] = _tiny_dp_step(rank, batch, False)
    finally:
        torch.backends.cudnn.conv.fp32_precision = prev
    return res


def dp_serving(card, device, out_dir) -> tuple[dict, dict]:
    """Phase 3f (c): the serving CLI at b8 f32, 2 batches, in one process
    (K1 held on its own inputs), with ``--mesh 1`` (NCCL) and with ``--mesh 2
    --gpus 0,0 --backend gloo`` (two ranks on the one card), the three runs
    at once and beside (b) (no time is read here): labels bit-equal to the single
    process's, and K1 launched once per rank per micro-batch (counted in
    the rank processes)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from fovealseg_torch.cli import infer as cli

    common = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--batch", "8", "--num-batches",
              "2", "MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
              "TRAIN.task_input_size", "(80,80)", "TPU.compute_dtype", "float32"]

    def serve(name, extra):
        t = time.perf_counter()
        out = cli.main(common[:4] + extra + ["--out", f"{out_dir}/{name}"] + common[4:])
        return out, time.perf_counter() - t

    runs = {}
    with ThreadPoolExecutor(2) as pool:
        meshes = {name: pool.submit(serve, name, extra) for name, extra in (
            ("mesh1", ["--mesh", "1"]),
            ("mesh2", ["--mesh", "2", "--gpus", "0,0", "--backend", "gloo"]))}
        with kernel_inputs() as seen:
            runs["single"], wall = serve("single", [])
            runs["single"]["wall_s"] = wall
        hold_on_path_inputs("single-process serving (the mesh runs' reference)", seen,
                            ("jfa_class",))
        for name, fut in meshes.items():
            ranks, wall = fut.result()
            runs[name] = dict(ranks[0], wall_s=wall,
                              launches_by_rank=[r["launches"] for r in ranks])
            if [r["launches"]["jfa_class"] for r in ranks] != [2] * len(ranks):
                raise AssertionError(f"--{name}: K1 launches per rank "
                                     f"{[r['launches'] for r in ranks]}, expected 2 each")
    names = sorted(n for n in os.listdir(f"{out_dir}/single") if n.endswith(".npy"))
    if len(names) != 16:
        raise AssertionError(f"single-process serving wrote {len(names)} masks, expected 16")
    for name in ("mesh1", "mesh2"):
        if sorted(n for n in os.listdir(f"{out_dir}/{name}") if n.endswith(".npy")) != names:
            raise AssertionError(f"--{name} wrote other mask files")
        for n in names:
            if not np.array_equal(np.load(f"{out_dir}/{name}/{n}"),
                                  np.load(f"{out_dir}/single/{n}")):
                raise AssertionError(f"--{name} labels of {n} != the single process's")
    log(f"mesh serving: --mesh 1 (NCCL) and --mesh 2 (gloo, two ranks on one card) labels "
        f"bit-equal to one process's on 16 b8 frames (2 batches: no throughput is read "
        f"here); run at once: " + "; ".join(f"{k} {v['wall_s']:.1f} s with start-up"
                                            for k, v in runs.items()) + f" on {card}")
    counts = {"dp_serve_mesh1": {"jfa_class": sum(r["jfa_class"]
                                                  for r in runs["mesh1"]["launches_by_rank"])},
              "dp_serve_mesh2": {"jfa_class": sum(r["jfa_class"]
                                                  for r in runs["mesh2"]["launches_by_rank"])}}
    return runs, counts


def parallel_path(card, device, out_dir):
    """Phase 3f."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from fovealseg_torch.data.synthetic import make_batch
    from fovealseg_torch.parallel.launch import run_workers

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tiny_batch = make_batch(np.random.default_rng(SEED + 42), 8, canvas=64)
    t = time.perf_counter()
    (one,) = run_workers(1, dp_world_one, device="cuda", timeout=300, echo=True)
    log(f"3f (a) took {time.perf_counter() - t:.1f} s")
    # the host reference and (c) run beside (b): none of them reads a time, (a) does
    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(run_workers, 2, dp_tiny_host, tiny_batch, device="cpu", timeout=300)
        serve = pool.submit(dp_serving, card, device, out_dir)
        t = time.perf_counter()
        two = run_workers(2, dp_two_ranks_one_card, tiny_batch, device=[0, 0], backend="gloo",
                          timeout=300, echo=True)
        log(f"3f (b) took {time.perf_counter() - t:.1f} s")
        serving, counts = serve.result()
        log(f"3f (c), beside (b), ended {time.perf_counter() - t:.1f} s after (b) began")
        ref = host.result()
        log(f"the host reference of (b) ended {time.perf_counter() - t:.1f} s after (b) began")
    res = {"world_one": {k: one[k] for k in ("default", "nearest", "times",
                                             "nondeterministic_ops")}, "serving": serving}
    plain, dp = one["times"]["plain"], one["times"]["dp"]
    iqr = (plain["step_ms_q3"] - plain["step_ms_q1"]) / plain["step_ms_median"]
    log(f"world-1 DDP step vs plain step, b8 f32, taken in turn: {json.dumps(one['times'])}; "
        f"DDP/plain median {dp['step_ms_median'] / plain['step_ms_median']:.3f}, the plain "
        f"step's interquartile range {iqr:.3f} of its median, on {card}")
    if one["nondeterministic_ops"]:
        log(f"ops that warned under deterministic algorithms: {one['nondeterministic_ops']}")
    inv = {k: two[0][k] for k in ("loss", "bn_layers_synced", "tensors", "elements",
                                  "mismatched_elements", "max_abs_diff")}
    inv["mismatched_elements_rank1"] = two[1]["mismatched_elements"]
    log(f"two gloo ranks on one card, flagship global b8 with cross-rank BN: {json.dumps(inv)}")
    if inv["mismatched_elements_rank1"] or not inv["bn_layers_synced"]:
        raise AssertionError("after one data-parallel step the two ranks' parameters or BN "
                             "statistics differ")
    card32, h32, h64 = two[0]["tiny"], ref[0]["f32"], ref[0]["f64"]
    c64, g64 = abs(card32["loss"] - h64["loss"]), abs(h32["loss"] - h64["loss"])
    tiny = {"loss_card": card32["loss"], "loss_host": h32["loss"], "loss_host64": h64["loss"],
            "loss": dict(card=c64, host=g64, bound=2 * g64 + 1e-6 * abs(h64["loss"])),
            "groups": {}}
    for g in h64["grads"]:
        f = h64["grads"][g].double()
        c64 = float((card32["grads"][g].double() - f).norm())
        g64 = float((h32["grads"][g].double() - f).norm())
        tiny["groups"][g] = dict(card=c64, host=g64, bound=2 * g64 + 1e-3 * float(f.norm()),
                                 norm=float(f.norm()))
    log(f"tiny two-rank gloo step, card vs host against the float64 yardstick: {json.dumps(tiny)}")
    far = {g: v for g, v in [("loss", tiny["loss"]), *tiny["groups"].items()]
           if v["card"] > v["bound"]}
    if far:
        raise AssertionError("the tiny data-parallel step on the card is farther from the "
                             f"float64 step than twice the host's distance: {far}")
    res["two_ranks_one_card"] = dict(inv, tiny=tiny)
    counts["dp_train_high_res"] = one["counts"]["nearest"]
    for label in ("default", "nearest"):
        r = one[label]
        if r["mismatched_elements"] or r["loss_plain"] != r["loss_dp"] or not r["metrics_equal"]:
            raise AssertionError(f"world-1 DDP '{label}' step != the single-process step: {r}")
    res["phase_3f_s"] = time.perf_counter() - t_phase
    log(f"phase 3f took {res['phase_3f_s']:.1f} s on {card}")
    return res, counts


# --------------------------------------------------------------- phase 3g

DATA_KEYS = ("img_data", "focus_point", "seg_label", "cls_label")
# the ODGT records of phase 3g (H, W): two orientations, an odd H*W, a big frame
ODGT_RECORDS = ((512, 683), (683, 512), (375, 501), (1024, 1365))
ODGT_OPTS = ["VAL.y_sampled_reverse", "True", "TRAIN.seed", str(SEED)]


def write_lvis(root: str, n_images: int = 12) -> tuple[str, str]:
    """An LVIS-format json of ``n_images`` images from 480x640 to 640x640,
    four polygons each over the monitored ids that the flagship's 51 classes
    hold (21 of the 49 map to a training id of 50 or above), and a JPEG per
    image. Returns (json path, image root)."""
    import os

    import numpy as np
    from PIL import Image

    from fovealseg_torch.data.lvis import CIDS_MONITORED, convert_index

    cids = [c for c in CIDS_MONITORED if convert_index(c) < 50]
    rng = np.random.default_rng(SEED + 70)
    img_root = os.path.join(root, "images")
    os.makedirs(img_root, exist_ok=True)
    images, anns = [], []
    for i in range(1, n_images + 1):
        h = 480 if i == 1 else 640 if i == 2 else int(rng.integers(480, 641))
        w = 640 if i <= 2 else int(rng.integers(480, 641))
        images.append({"id": i, "height": h, "width": w})
        cells = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = cells.repeat(16, 0).repeat(16, 1)[:h, :w]
        Image.fromarray(img).save(os.path.join(img_root, f"{i}.jpg"), quality=90)
        for k in range(4):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
            a = np.sort(rng.uniform(0, 2 * np.pi, 7))
            poly = np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], 1).reshape(-1)
            anns.append({"id": 100 * i + k, "image_id": i, "category_id": cids[(4 * i + k) % 28],
                         "segmentation": [poly.tolist()]})
    path = os.path.join(root, "lvis.json")
    with open(path, "w") as fh:
        json.dump({"images": images, "annotations": anns}, fh)
    return path, img_root


@contextlib.contextmanager
def watch_train_cli():
    """The first batch the train step is given (device copies of its data
    keys) and each epoch's seconds (ending in a synchronise), from inside the
    train CLI."""
    import torch

    from fovealseg_torch.train import loop
    from fovealseg_torch.train import step as S

    seen = {"first": None, "epoch_s": []}
    make, one_epoch = S.make_train_step, loop.train_one_epoch

    def make_watched(*a, **k):
        fn = make(*a, **k)

        def step(state, batch):
            if seen["first"] is None:
                seen["first"] = {key: batch[key].clone() for key in DATA_KEYS}
            return fn(state, batch)
        return step

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = one_epoch(*a, **k)
        torch.cuda.synchronize()
        seen["epoch_s"].append(time.perf_counter() - t)
        return out

    S.make_train_step, loop.train_one_epoch = make_watched, timed
    try:
        yield seen
    finally:
        S.make_train_step, loop.train_one_epoch = make, one_epoch


def lvis_path(card, out_dir, synthetic_sps) -> tuple[dict, dict]:
    """Phase 3g (a): cook an LVIS-format set through ``cli.cook.main`` (24
    train, 8 valid), train the flagship on it through ``cli.train.main
    --data`` at b8 f32 (two reconciled epochs of 3 steps; the first batch on
    the card against the reader's host batch, bit for bit), then evaluate its
    checkpoint through ``cli.eval.main --data`` (K1, K2 and K5 launched once
    per batch)."""
    import os

    import numpy as np
    import torch

    from fovealseg_torch.cli import cook
    from fovealseg_torch.cli import eval as ecli
    from fovealseg_torch.cli import train as tcli
    from fovealseg_torch.data.lvis import DatasetLVIS

    path, img_root = write_lvis(out_dir)
    root, d = os.path.join(out_dir, "cook"), os.path.join(out_dir, "run")
    t = time.perf_counter()
    for part, n in (("train", "24"), ("valid", "40")):
        if cook.main(["lvis", f"--{part}-json", path, "--dataset-partition", part,
                      "--out", root, "--sample-num", n]) != 0:
            raise AssertionError(f"cook {part} wrote nothing")
    cook_s = time.perf_counter() - t
    markers = ["DATASET.dataset_marker_train", "sp24", "DATASET.dataset_marker_valid", "sp8"]
    train_ds = DatasetLVIS(os.path.join(root, "train"), img_root, marker="sp24")
    val_ds = DatasetLVIS(os.path.join(root, "valid"), img_root, marker="sp8")
    if (len(train_ds), len(val_ds), train_ds.n_textured) != (24, 8, 0):
        raise AssertionError(f"cooked {len(train_ds)} train / {len(val_ds)} valid, "
                             f"{train_ds.n_textured} without an image")
    t = time.perf_counter()
    for i in range(len(train_ds)):
        train_ds[i]
    host_ms = (time.perf_counter() - t) * 1e3 / len(train_ds)

    opts = [*TRAIN_OPTS, "TPU.compute_dtype", "float32", *markers]
    with watch_train_cli() as seen:
        t = time.perf_counter()
        state = tcli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--data", root,
                           "--image-root", img_root, *opts, "TRAIN.num_epoch", "2",
                           "DIR", d])
        cli_s = time.perf_counter() - t
    if state.step != 6:
        raise AssertionError(f"train --data: step {state.step} after 2 epochs of 24 / 8")
    del state
    host = next(iter(train_ds.batches(8, shuffle=True, seed=SEED + 1)))
    for k in DATA_KEYS:
        got, want = seen["first"][k], torch.from_numpy(host[k])
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            raise AssertionError(f"train --data: the first batch's {k} on the card != the "
                                 f"reader's host batch")
    sps = 24 / seen["epoch_s"][-1]
    reset_counts()
    result = ecli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--data", root,
                        "--image-root", img_root, "--num-batches", "1", *opts,
                        "VAL.batch_size", "8", "VAL.y_sampled_reverse", "True",
                        "TRAIN.start_epoch", "2", "DIR", d])
    counts = read_counts()
    check_counts("lvis_eval (1 b8 batch)", counts,
                 {**dict.fromkeys(counts, 0), "jfa_class": 1, "jfa_relpay": 1, "row_gather": 1})
    check_result("eval --data of the epoch-2 checkpoint", result, 1)
    res = dict(cook_s=cook_s, reader_host_ms_per_sample=host_ms, train_cli_s=cli_s,
               epoch_s=seen["epoch_s"], train_cli_samples_per_s=sps,
               synthetic_samples_per_s=synthetic_sps,
               eval={k: v for k, v in result.items() if k != "per_class_iou"},
               first_batch_bit_equal=True)
    log(f"lvis: cooked 24 + 8 in {cook_s:.1f} s; reader {host_ms:.2f} ms/sample on the host "
        f"(JPEG decode, pad); train CLI --data b8 f32: {sps:.2f} samples/s over epoch 2 "
        f"(epochs {[round(s, 3) for s in seen['epoch_s']]} s; phase 3d synthetic "
        f"{synthetic_sps:.2f}), first batch on the card bit-equal to the host's; eval --data: "
        f"{json.dumps(res['eval'])} on {card}")
    return res, counts


def write_odgt(root: str) -> str:
    """ADE20K-format records (JPEG image, PNG label of ids 0..150 in 16-pixel
    blocks, 0 = ignore) at ``ODGT_RECORDS``; returns the list's path."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 80)
    recs = []
    for i, (h, w) in enumerate(ODGT_RECORDS):
        cells = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = cells.repeat(16, 0).repeat(16, 1)[:h, :w]
        Image.fromarray(img).save(os.path.join(root, f"ADE_val_{i}.jpg"), quality=90)
        seg = rng.integers(0, 151, (h // 16 + 1, w // 16 + 1)).repeat(16, 0).repeat(16, 1)
        Image.fromarray(seg[:h, :w].astype(np.uint8)).save(os.path.join(root, f"ADE_val_{i}.png"))
        recs.append({"fpath_img": f"ADE_val_{i}.jpg", "fpath_segm": f"ADE_val_{i}.png",
                     "width": w, "height": h})
    path = os.path.join(root, "val.odgt")
    with open(path, "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in recs))
    return path


@contextlib.contextmanager
def odgt_kernel_inputs():
    """Copies of the inputs of K2 and K5 where ``core/unwarp.py`` calls them,
    the last call per (kernel, canvas, channels), and every round count
    ``jfa_rounds_from_grid`` returned (device scalars)."""
    import torch

    from fovealseg_torch.core import unwarp
    from fovealseg_torch.models import deform_module

    seen, rounds = {}, []
    saved = {"nearest_payload_packed": unwarp.nearest_payload_packed,
             "row_gather": unwarp.row_gather}
    saved_rounds = deform_module.jfa_rounds_from_grid

    def recording(name, fn):
        def call(*args):
            a0 = args[0]
            key = (name, tuple(a0.shape[1:]) if name != "row_gather" else
                   (args[1].shape[1], a0.shape[2]))
            seen[key] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return fn(*args)
        return call

    def rounds_of(grid, seg_hw):
        r = saved_rounds(grid, seg_hw)
        rounds.append(r)
        return r

    try:
        for name, fn in saved.items():
            setattr(unwarp, name, recording(name, fn))
        deform_module.jfa_rounds_from_grid = rounds_of
        yield seen, rounds
    finally:
        for name, fn in saved.items():
            setattr(unwarp, name, fn)
        deform_module.jfa_rounds_from_grid = saved_rounds


def odgt_path(card, device, out_dir) -> tuple[dict, dict, dict]:
    """Phase 3g (b): the multi-scale ADE20K evaluation (``cli.eval_odgt.main``)
    of the flagship at ``configs/ade20k.yaml`` (150 classes, 5 scales,
    ``imgMaxSize`` 1000, padding 32, the label round trip) on four records,
    random weights from the seed; K2 and K5 counted per record and held
    bit-equal to their plain versions on the path's own inputs at the
    largest and the odd canvas (and timed there); one record's labels with
    the plain K2 and K5 on the card bit-equal to the kernels'; the device
    time per scale under torch.profiler; ``--no-deform`` on one record."""
    import logging

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.cli import eval_odgt
    from fovealseg_torch.cli.eval import load_weights
    from fovealseg_torch.configs import get_default_cfg
    from fovealseg_torch.core import unwarp
    from fovealseg_torch.ops import gather, jfa

    odgt = write_odgt(out_dir)
    args = ["--cfg", "fovealseg_torch/configs/ade20k.yaml", *ODGT_OPTS,
            "DATASET.root_dataset", out_dir, "DATASET.list_val", odgt]
    cli_args = args + ["DIR", f"{out_dir}/run"]
    per_record, timing = [], {}

    def on_record(idx, rec, res):
        per_record.append({"hw": list(res["seg"].shape), "launches": read_counts()})
        reset_counts()
        for k in ("scores", "pred"):
            if not bool(torch.isfinite(res[k].float()).all()):
                raise AssertionError(f"odgt record {idx}: non-finite {k}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with odgt_kernel_inputs() as (seen, rounds):
        result = eval_odgt.main(cli_args, on_record=on_record, timing=timing)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    max_rounds = max(int(r) for r in rounds)
    counts = {k: sum(r["launches"][k] for r in per_record) for k in per_record[0]["launches"]}
    n_scales = len(result["scales"])
    for r in per_record:
        # per scale: K2 and K5 for the score map, again for the label round trip
        want = {**dict.fromkeys(counts, 0), "jfa_relpay": 2 * n_scales,
                "row_gather": 2 * n_scales}
        got = r["launches"]
        if got["jfa_payload"]:  # K3 would take over past a host-known count; none is host-known
            want["jfa_relpay"] -= got["jfa_payload"]
            want["jfa_payload"] = got["jfa_payload"]
        check_counts(f"odgt_eval record {r['hw']} ({n_scales} scales, score map + label "
                     f"round trip)", got, want)
    if result["num_samples"] != 4 or not all(
            0 <= result[k] <= 1 for k in ("mean_iou", "pixel_acc", "mean_iou_deformed",
                                          "pixel_acc_deformed", "y_reverse_iou",
                                          "y_reverse_acc")):
        raise AssertionError(f"odgt result malformed: {result}")

    # the path's own inputs at the largest and the odd canvas, bit-equal; timed
    pairs = {"nearest_payload_packed": (jfa.nearest_payload_packed,
                                        jfa.nearest_payload_packed_plain),
             "row_gather": (gather.row_gather, gather.row_gather_plain)}
    held, numbers = [], {}
    for (name, _), a in sorted(seen.items(), key=lambda kv: str(kv[0])):
        hw = tuple(a[0].shape[1:]) if name != "row_gather" else None
        n_px = a[0].numel() if name != "row_gather" else a[1].numel()
        if n_px not in (1024 * 1365, 375 * 501):
            continue
        kernel, plain = pairs[name]
        if name == "nearest_payload_packed":
            label = f"odgt {list(hw)}, runtime rounds={int(a[3])}"
            r = hold("jfa_relpay", label, lambda a=a: kernel(*a), lambda a=a: plain(*a),
                     n_px * (1 + 4 + 4) / HBM_BYTES_PER_S * 1e3, n=10)
            r["rounds"] = int(a[3])
            numbers[f"jfa_relpay {list(hw)}"] = r
        else:
            table, idx = a
            c = table.shape[2]
            label = f"odgt C = {c}, {n_px} px"
            flat = idx.reshape(-1).long()
            table2 = table.reshape(-1, c)
            r = hold("row_gather", label, lambda a=a: kernel(*a), lambda a=a: plain(*a),
                     (n_px * c * 4 + n_px * 4 + table.numel() * 4) / HBM_BYTES_PER_S * 1e3,
                     libraries={"index_select": lambda t=table2, i=flat: torch.index_select(
                         t, 0, i)}, n=10)
            out_k = kernel(*a)
            r["variant"] = gather.VARIANT_NAMES[gather.gather_variant(
                c, idx.shape[1], table.data_ptr(), idx.data_ptr(), out_k.data_ptr())]
            del out_k
            numbers[f"row_gather C={c} {n_px}px"] = r
        held.append(label)
    if len(held) != 6:  # K2, K5 at C = 150 and C = 1, at both canvases
        raise AssertionError(f"odgt: held {held}, expected K2 and K5 (C = 150, 1) at "
                             f"1024x1365 and 375x501")
    del seen
    torch.cuda.empty_cache()

    # one record again: plain K2 and K5 on the card give the same labels
    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/ade20k.yaml")
    cfg.merge_from_list(args[2:])
    module = eval_odgt.build_module(cfg, False, device)
    load_weights(module, cfg, None, "last", logging.getLogger("fovealseg"))
    ds = eval_odgt.val_dataset(cfg)
    rec = ds[2]  # 375x501
    ran = eval_odgt.evaluate_record(module, rec, (0.5, 0.5), device, rev_y=True)
    saved = {"nearest_payload_packed": unwarp.nearest_payload_packed,
             "row_gather": unwarp.row_gather}
    try:
        unwarp.nearest_payload_packed = jfa.nearest_payload_packed_plain
        unwarp.row_gather = gather.row_gather_plain
        ref = eval_odgt.evaluate_record(module, rec, (0.5, 0.5), device, rev_y=True)
    finally:
        for name, fn in saved.items():
            setattr(unwarp, name, fn)
    for k in ("pred", "y_sampled_reverse", "scores"):
        if not torch.equal(ran[k], ref[k]):
            raise AssertionError(f"odgt record 375x501: {k} with the kernels != with the plain "
                                 f"versions on the card")
    del ran, ref

    # device time per scale, the big record
    big = ds[3]
    eval_odgt.evaluate_record(module, big, (0.5, 0.5), device, rev_y=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eval_odgt.evaluate_record(module, big, (0.5, 0.5), device, rev_y=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eval_odgt.evaluate_record(module, big, (0.5, 0.5), device, rev_y=True)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = {}
    for e in kernels:
        top[e.name[:50]] = top.get(e.name[:50], 0.0) + e.time_range.elapsed_us() / 1e3
    per_scale = dict(record="1024x1365", record_wall_ms=wall_ms, device_busy_ms=busy_ms,
                     device_busy_ms_per_scale=busy_ms / n_scales,
                     kernels_per_scale=len(kernels) / n_scales,
                     top_kernels_ms=dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]))
    del module, big
    torch.cuda.empty_cache()

    nd = eval_odgt.main(cli_args[:2] + ["--no-deform", "--num-samples", "1"] + cli_args[2:])
    if nd["num_samples"] != 1 or "mean_iou_deformed" in nd or not 0 <= nd["mean_iou"] <= 1:
        raise AssertionError(f"odgt --no-deform result malformed: {nd}")
    res = dict(result=result, no_deform=nd, seconds_per_record=timing["seconds_per_record"],
               records=[r["hw"] for r in per_record], launches_per_record=per_record,
               max_device_rounds=max_rounds, peak_gib=peak_gib, per_scale=per_scale,
               compute_dtype=cfg.TPU.compute_dtype)
    log(f"odgt: {json.dumps(result)}; seconds per record "
        f"{[round(s, 3) for s in timing['seconds_per_record']]} for {res['records']}; largest "
        f"device round count {max_rounds}; peak {peak_gib:.2f} GiB; 1024x1365 record: "
        f"{wall_ms:.1f} ms wall, device busy {busy_ms / n_scales:.2f} ms and "
        f"{len(kernels) / n_scales:.0f} kernels per scale ({cfg.TPU.compute_dtype}); "
        f"--no-deform: {json.dumps(nd)} on {card}")
    log(f"odgt top kernels (ms per record): {json.dumps(per_scale['top_kernels_ms'])}")
    return res, counts, numbers


def real_data_path(card, device, out_dir, synthetic_sps):
    """Phase 3g."""
    import os

    t = time.perf_counter()
    os.makedirs(f"{out_dir}/lvis", exist_ok=True)
    os.makedirs(f"{out_dir}/odgt", exist_ok=True)
    lvis, lvis_counts = lvis_path(card, f"{out_dir}/lvis", synthetic_sps)
    odgt, odgt_counts, numbers = odgt_path(card, device, f"{out_dir}/odgt")
    seconds = time.perf_counter() - t
    log(f"phase 3g took {seconds:.1f} s on {card}")
    return dict(lvis=lvis, odgt=odgt, phase_3g_s=seconds), {"lvis_eval": lvis_counts,
                                                           "odgt_eval": odgt_counts}, numbers


# --------------------------------------------------------------- phase 3h

# SGD: an update's norm then measures its gradient (Adam's first update does not)
MESH_OPTS = ("TRAIN.optim", "sgd")
MESH_HIGH_RES_KERNELS = ("jfa_relpay", "row_gather", "row_gather_backward")
SPATIAL_FRAMES = 3  # timed b1 frames per spatial rank and model
# decided pixels of (c) that may differ from one process's (2 b8 batches,
# 6,553,600 decided pixels; 10 differed on the H100)
NONSYN_FLIPS = 100
SERVE_F32_OPTS = ["MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
                  "TRAIN.task_input_size", "(80,80)", "TPU.compute_dtype", "float32"]


def _ieee_convs():
    """Full f32 convs (no TF32), for a comparison across conv shapes."""
    import torch

    torch.backends.cudnn.conv.fp32_precision = "ieee"


# the default step in the CPU test's configuration: with the learned warp the
# warped labels are truncated bilinear samples of the mask, and a grid that
# moves by its last bits between two f32 computations flips some of them;
# 'BI' resizes the labels instead, and the four groups still train through
# the joint edge loss
MESH_DEFAULT = ("MODEL.uniform_sample", "BI", "TRAIN.deform_joint_loss", "True")


def _mesh_case(label):
    """'default' (the CPU test's configuration) or 'nearest' (the learned
    warp with ``loss_at_high_res``: the labels are the full-resolution mask,
    and the inverse warp runs K2, K5 and K5b), SGD; a label ending in '_f64'
    is its step with float64 sub-networks."""
    extra = DP_HIGH_RES if label.startswith("nearest") else MESH_DEFAULT
    return train_cfg(*TRAIN_OPTS, *MESH_OPTS, *extra)


# phase 3h (a)'s steps: the f32 steps are timed; the '_f64' steps, their
# float64 witnesses (``float64_nets``: the sub-networks compute in f64, the
# geometry and the losses in f32, K2, K5 and K5b launch as in f32), hold the
# gradients to the CPU test's tolerances and more, out of f32's rounding
MESH_STEPS = ("default", "nearest", "default_f64", "nearest_f64")


def _mesh_bases(device) -> dict:
    """The flagship of each phase 3h (a) configuration ('default',
    'nearest'), built once from the seed; each step takes a copy."""
    import torch

    out = {}
    for name in ("default", "nearest"):
        cfg = _mesh_case(name)
        out[name] = flagship(torch.float32, device, loss_at_high_res=cfg.MODEL.loss_at_high_res,
                             rev_deform_interp=cfg.MODEL.rev_deform_interp,
                             arch_encoder=cfg.MODEL.arch_encoder, fc_dim=cfg.MODEL.fc_dim,
                             saliency_net=cfg.MODEL.saliency_net)
    return out


def _mesh_state(bases, label, dropout=True):
    """The state of a phase 3h (a) step: a copy of its configuration's base
    model (``float64_nets`` for an '_f64' label)."""
    import copy

    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer

    cfg = _mesh_case(label)
    base = bases[label.split("_")[0]]
    model = float64_nets(base) if label.endswith("_f64") else copy.deepcopy(base)
    if not dropout:
        _no_dropout(model)
    return cfg, S.init_state(model, create_optimizer(cfg, model), SEED)


def _param_bytes(model) -> dict:
    """Parameter bytes of ``model``; Adam's two moments hold twice as many."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    wide = sum(p.numel() * p.element_size() for p in model.parameters()
               if getattr(p, "model_shard", None) is not None)
    return {"param_bytes": n, "adam_moment_bytes": 2 * n, "sharded_param_bytes": wide}


def _timed_step(state, step, batch, profiled: bool) -> dict:
    """One step on the host clock (ending in a synchronise); with
    ``profiled``, under torch.profiler's device tracing (device busy,
    kernels; the wall then includes the tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext() \
            as prof:
        t = time.perf_counter()
        mets = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    if not profiled:
        return {"wall_ms": wall, "mets": mets}
    kernels = device_kernels(prof)
    return {"profiled_wall_ms": wall, "mets": mets, "kernels_per_step": len(kernels),
            "device_busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}


def _host_sd(model) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def mesh_2d_one_process(device, bases, labels) -> dict:
    """Phase 3h (a)'s references: for each of ``labels`` (of ``MESH_STEPS``,
    and 'default_nodrop' and 'default_f64_nodrop': one process's f32
    rounding against f64, dropout off) the flagship's one-process SGD step
    on the global b8 batch (TF32 off), its metrics, updated state dict (on
    the host) and seconds; an f32 step's wall, then a second step under
    torch.profiler (device busy, kernels); with 'default', 'old': the
    weights before."""
    import torch

    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.loop import batch_controls
    from fovealseg_torch.train.optim import make_stage_schedules

    _ieee_convs()
    (full,) = _batches(device, 1, SEED + 60)
    out = {}
    for label in labels:
        t = time.perf_counter()
        cfg, state = _mesh_state(bases, label.removesuffix("_nodrop"),
                                 dropout=not label.endswith("_nodrop"))
        step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))
        if label == "default":
            out["old"] = _host_sd(state.model)
        batch = {**full, **batch_controls(cfg, 1, 0, state.pool_rng)}
        r = _timed_step(state, step, batch, False)
        res = {"wall_ms": r["wall_ms"], "mets": {k: float(v) for k, v in r["mets"].items()},
               "sd": _host_sd(state.model), **_param_bytes(state.model)}
        if label in ("default", "nearest"):
            res.update({k: v for k, v in _timed_step(state, step, batch, True).items()
                        if k != "mets"})
        out[label] = res
        del state, step
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t
    return out


def _wait_for(path, fut) -> None:
    """Until the file ``path`` exists (or the future ``fut`` has ended)."""
    import os

    while not os.path.exists(path) and (fut is None or not fut.done()):
        time.sleep(0.2)


def mesh_2d_rank(rank, out_dir: str):
    """Phase 3h (a), one of four gloo ranks on the one card: the flagship on
    the 2 x 2 mesh, TF32 off, from the same weights and global b8 batch as
    the one-process references. The f32 steps wait for the file 'go' in
    ``out_dir`` (the timed references run alone first), and rank 0 writes
    'timed' once every rank has taken them (the f64 references then run
    beside the f64 steps). For each of ``MESH_STEPS``, one step (the f32
    ones under torch.profiler's device tracing): its kernel counts, read in
    the rank just after it, K2, K5 and K5b held on the step's own inputs
    ('nearest'), the metrics, the gathered state dict (rank 0 returns it),
    the wall, device busy, kernels and seconds."""
    import os

    import torch
    import torch.distributed as dist

    from fovealseg_torch.parallel.mesh import (gather_state_2d, make_mesh_2d, shard_batch,
                                               shard_model_2d)
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.loop import batch_controls
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    _ieee_convs()
    device = rank.device
    mesh = make_mesh_2d(2, 2)
    (full,) = _batches(device, 1, SEED + 60)
    bases = _mesh_bases(device)
    _wait_for(os.path.join(out_dir, "go"), None)
    dist.barrier()  # every rank has built its bases: the first timed step starts together
    out = {"place": (mesh.data_index, mesh.model_index)}
    for label in MESH_STEPS:
        if label == "default_f64":  # the f32 steps are done on every rank
            dist.barrier()
            if rank.rank == 0:
                open(os.path.join(out_dir, "timed"), "w").close()
        t = time.perf_counter()
        kernels = MESH_HIGH_RES_KERNELS if label.startswith("nearest") else ()
        cfg, state = _mesh_state(bases, label)
        res = {"sharded_layers": shard_model_2d(state.model, mesh)}
        state.optimizer = create_optimizer(cfg, state.model)
        state.mesh = mesh
        step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg),
                                 mesh=mesh)
        batch = shard_batch({**full, **batch_controls(cfg, 1, 0, state.pool_rng)},
                            mesh.data_index, mesh.dp)
        torch.cuda.synchronize()
        reset_counts()
        with kernel_inputs() as seen:
            r = _timed_step(state, step, batch, not label.endswith("_f64"))
        res["counts"] = read_counts()
        res["mets"] = {k: float(v) for k, v in r.pop("mets").items()}
        res.update(r)
        if kernels:
            hold_on_path_inputs(f"2-D rank {rank.rank} '{label}' step", seen, kernels)
        del seen
        sd = gather_state_2d(state.model, None, mesh)[0]
        res["sd"] = sd if rank.rank == 0 else None
        res.update(_param_bytes(state.model))
        out[label] = res
        del state, step
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t
    return out


# the float64 witnesses' limits on each group's update: its direction
# (|du - dr| / |dr|) and its norm (|du| / |dr| - 1); read on the 2 x 2 mesh on
# the H100: at most 4.9e-7 and 2.6e-7 (f32: up to 0.23 and 0.05)
F64_UPDATE_LIMIT = 1e-5


def _update(got: dict, ref: dict, old: dict, keys, device) -> tuple[float, float]:
    """(direction, norm ratio) of the update ``got - old`` against ``ref -
    old``, in f64 on ``device``."""
    import torch

    acc = torch.zeros(3, dtype=torch.float64, device=device)
    for k in keys:
        o = old[k].to(device, torch.float64)
        du, dr = got[k].to(device, torch.float64) - o, ref[k].to(device, torch.float64) - o
        acc += torch.stack([(du - dr).square().sum(), du.square().sum(), dr.square().sum()])
    diff, norm, scale = acc.sqrt().tolist()
    scale = max(scale, 1e-300)
    return diff / scale, norm / scale


def _held_2d(got: dict, ref: dict, old: dict, f64: bool, device) -> dict:
    """The 2-D step against the one-process step: the failures and the
    numbers. Both: the metrics within rtol 1e-4. A float64 witness
    (``f64``) is held to the CPU test's tolerances and more: every
    parameter and BN statistic within rtol 2e-3 and atol 2e-5, and each
    group's update within ``F64_UPDATE_LIMIT`` in direction and norm. An
    f32 step: the encoder's and decoder's parameters within the CPU test's
    tolerances and each group's update norm within 10% (a gradient off by a
    factor of dp or mp, 2 here, moves it by 50% or 100%); its update
    directions are printed. At the flagship's random init f32 rounding
    alone moves the one-process update's direction by a third from the f64
    one (the 'conditioning' numbers): the class branch's upstream gradient
    is nearly the same for every sample and pixel, BN's backward cancels
    most of it, and a data block's BN sums round unlike the global batch's."""
    import torch

    from fovealseg_torch.train.optim import GROUPS

    bad = []
    worst = {"mets_rel": 0.0, "params_excess": {}, "stats_excess": {}, "direction": {},
             "norm_ratio": {}}
    for k, v in ref["mets"].items():
        rel = abs(got["mets"][k] - v) / max(abs(v), 1e-30)
        worst["mets_rel"] = max(worst["mets_rel"], rel)
        if rel > 1e-4:
            bad.append(k)

    def excess(ks):
        out = torch.full((), float("-inf"), dtype=torch.float64, device=device)
        for k in ks:
            a = got["sd"][k].to(device, torch.float64)
            b = ref["sd"][k].to(device, torch.float64)
            out = torch.maximum(out, ((a - b).abs() - (2e-5 + 2e-3 * b.abs())).max())
        return float(out)

    for name, sub, _, _ in GROUPS:
        keys = [k for k in ref["sd"] if k.startswith(sub + ".")
                and ref["sd"][k].is_floating_point()]
        trained = [k for k in keys if "running_" not in k]
        worst["params_excess"][name] = excess(trained)
        worst["stats_excess"][name] = excess([k for k in keys if "running_" in k])
        direction, ratio = _update(got["sd"], ref["sd"], old, trained, device)
        worst["direction"][name], worst["norm_ratio"][name] = direction, ratio
        if f64:
            if worst["params_excess"][name] > 0 or worst["stats_excess"][name] > 0:
                bad.append(f"{name} parameters or BN statistics")
            if direction > F64_UPDATE_LIMIT or abs(ratio - 1.0) > F64_UPDATE_LIMIT:
                bad.append(f"{name} update")
        else:
            if worst["params_excess"][name] > 0 and name in ("encoder", "decoder"):
                bad.append(f"{name} parameters")
            if abs(ratio - 1.0) > 0.1:
                bad.append(f"{name} update norm")
    return {"failures": bad[:20], **worst}


def mesh_2d_path(card, device, out_dir) -> tuple[dict, dict]:
    """Phase 3h (a): the timed f32 references alone, the ranks' f32 steps,
    then the f64 references beside the ranks' f64 steps."""
    import os

    import torch

    from fovealseg_torch.parallel.launch import run_workers
    from fovealseg_torch.train.optim import GROUPS

    t = time.perf_counter()
    prev = torch.backends.cudnn.conv.fp32_precision
    with ThreadPoolExecutor(1) as pool:
        # the ranks start up while the timed references run
        ranks = pool.submit(run_workers, 4, mesh_2d_rank, out_dir, device=[0, 0, 0, 0],
                            backend="gloo", timeout=600, echo=True)
        try:
            bases = _mesh_bases(device)
            ref = mesh_2d_one_process(device, bases, ("default", "nearest"))
            open(os.path.join(out_dir, "go"), "w").close()
            t_timed = time.perf_counter() - t
            _wait_for(os.path.join(out_dir, "timed"), ranks)
            t_ranks = time.perf_counter() - t
            f64 = mesh_2d_one_process(device, bases, ("default_f64", "nearest_f64",
                                                      "default_nodrop", "default_f64_nodrop"))
            del bases
            ref.update(f64)
        finally:
            torch.backends.cudnn.conv.fp32_precision = prev
            open(os.path.join(out_dir, "go"), "w").close()
        ranks = ranks.result()
    seconds = {"f32_references": t_timed, "f32_steps_done": t_ranks,
               "total": time.perf_counter() - t,
               "references": {k: v["seconds"] for k, v in ref.items() if k != "old"},
               "rank0_steps": {k: ranks[0][k]["seconds"] for k in MESH_STEPS}}
    log(f"3h (a) took {seconds['total']:.1f} s: {json.dumps(seconds)}")
    t = time.perf_counter()
    old = ref.pop("old")
    f32, f64 = ref.pop("default_nodrop")["sd"], ref.pop("default_f64_nodrop")["sd"]
    conditioning = {}
    for name, sub, _, _ in GROUPS:
        keys = [k for k in old if k.startswith(sub + ".") and old[k].is_floating_point()
                and "running_" not in k]
        conditioning[name] = dict(zip(("direction", "norm_ratio"),
                                      _update(f32, f64, old, keys, device)))
    log(f"one process, default step with dropout off, f32 against float64 sub-networks: "
        f"{json.dumps(conditioning)}")
    res, counts = {"conditioning_f32_vs_f64": conditioning}, {}
    for label in MESH_STEPS:
        r0, one = ranks[0][label], ref[label]
        held = _held_2d(r0, one, old, label.endswith("_f64"), device)
        same = all(r[label]["mets"] == r0["mets"] for r in ranks)
        n = {name: sum(r[label]["counts"][name] for r in ranks) for name in r0["counts"]}
        expect = dict.fromkeys(n, 0)
        if label.startswith("nearest"):
            expect.update(dict.fromkeys(MESH_HIGH_RES_KERNELS, 4))  # once per rank
        check_counts(f"2-D '{label}' step, 4 ranks", n, expect)
        counts[f"mesh2d_{label}"] = n
        # the f64 steps run beside each other: no time is read from them
        timing = ("wall_ms", "device_busy_ms", "kernels_per_step") if "device_busy_ms" in one \
            else ()
        res[label] = {
            "one_process": {k: one[k] for k in timing + ("param_bytes", "adam_moment_bytes")},
            "ranks": [{"place": r["place"], **{k: r[label][k] for k in (
                "profiled_wall_ms", "device_busy_ms", "kernels_per_step",
                "param_bytes", "adam_moment_bytes", "sharded_param_bytes", "sharded_layers")
                if k in r[label]}} for r in ranks],
            "loss_one_process": one["mets"]["loss"], "loss_2d": r0["mets"]["loss"],
            "metrics_equal_over_ranks": same, **held}
        log(f"2-D mesh 2x2 (4 gloo ranks on one card) '{label}' b8, TF32 off, against one "
            f"process: {json.dumps(res[label])} on {card}")
        if held["failures"] or not same:
            raise AssertionError(f"the 2-D '{label}' step != the one-process step: {held}")
    log(f"3h (a)'s comparisons took {time.perf_counter() - t:.1f} s")
    return res, counts


def spatial_rank(rank, runs):
    """Phase 3h (b), one of two gloo ranks on the one card, for each of
    ``runs`` ([(label, the serving CLI's argv)]) in turn: the CLI's model
    (``--spatial``), one b1 frame at a time in f32: 2 warm-up frames,
    ``SPATIAL_FRAMES`` timed (host clock, each ending in a synchronise), one
    under torch.profiler; exchanges and kernel launches per frame, K1 held
    on each timed frame's own inputs, and the last frame's labels."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.cli import infer as cli
    from fovealseg_torch.parallel import spatial

    out = {}
    for label, argv in runs:
        args, cfg, _ = cli._parse(argv)
        model = cli.build_model(cfg, rank.device)
        model.set_spatial(dist.group.WORLD)
        x, f = frames(1, CANVAS, SEED + 70, rank.device)
        for _ in range(2):
            model.infer(x, f, argmax_labels=True)
        torch.cuda.synchronize()
        reset_counts()
        before = spatial.exchanges
        walls, inputs = [], []
        for _ in range(SPATIAL_FRAMES):
            t = time.perf_counter()
            with kernel_inputs() as seen:
                pred_label = model.infer(x, f, argmax_labels=True)["pred_label"]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            inputs.append(seen)
        counts = read_counts()
        exchanges = (spatial.exchanges - before) / SPATIAL_FRAMES
        for i, seen in enumerate(inputs):
            hold_on_path_inputs(f"--spatial 2 {label} rank {rank.rank}, b1 frame {i}", seen,
                                ("jfa_class",))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.infer(x, f, argmax_labels=True)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        out[label] = {"wall_ms": statistics.median(walls), "walls_ms": walls,
                      "device_busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
                      "kernels_per_frame": len(kernels), "exchanges_per_frame": exchanges,
                      "counts": counts, "label": pred_label.cpu()}
        del model, inputs
        torch.cuda.empty_cache()
    return out


def _decided(scores):
    """Where the top-two margin of ``scores`` [..., C] exceeds 1e-4."""
    top2 = scores.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 1e-4


def _cli_masks(d):
    import os

    import numpy as np

    names = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
    return names, np.stack([np.load(os.path.join(d, n)) for n in names])


# phase 3h (b)'s models: label -> the serving CLI's options beside SERVE_F32_OPTS
SPATIAL_MODELS = {"flagship": [],
                  "segformer": ["MODEL.arch_encoder", "segformer", "MODEL.fc_dim", "1024"],
                  "deeplab": ["MODEL.arch_encoder", "deeplab"]}


def _one_process_frame(device, argv) -> dict:
    """One process's b1 frame of the serving CLI's model: its scores and
    labels, then 2 warm-up and ``SPATIAL_FRAMES`` timed frames (host clock)
    and one under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.cli import infer as cli

    _, cfg, _ = cli._parse(argv)
    model = cli.build_model(cfg, device)
    x, f = frames(1, CANVAS, SEED + 70, device)
    scores = model.infer(x, f)["pred_sampled"]
    one_label = model.infer(x, f, argmax_labels=True)["pred_label"]
    for _ in range(2):
        model.infer(x, f, argmax_labels=True)
    walls = []
    for _ in range(SPATIAL_FRAMES):
        torch.cuda.synchronize()
        s = time.perf_counter()
        model.infer(x, f, argmax_labels=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - s) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.infer(x, f, argmax_labels=True)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    out = {"decided": _decided(scores).cpu(), "label": one_label.cpu(),
           "wall_ms": statistics.median(walls), "walls_ms": walls,
           "device_busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
           "kernels_per_frame": len(kernels)}
    del model, scores
    torch.cuda.empty_cache()
    return out


def spatial_serving(card, device, b1) -> tuple[dict, dict]:
    """Phase 3h (b): for each of ``SPATIAL_MODELS``, one process's b1 frame
    (``_one_process_frame``), then one launch of two ``--spatial`` ranks
    that serve the models in turn (``spatial_rank``): their labels equal to
    one process's on every pixel that its scores decide, K1 once per frame
    on each rank, their frames timed beside one process's."""
    import torch

    from fovealseg_torch.parallel.launch import run_workers

    t = time.perf_counter()
    runs = [(label, ["--cfg", "fovealseg_torch/configs/deform.yaml", "--num-batches", "2",
                     "--batch", "1", "--spatial", "2"] + SERVE_F32_OPTS + extra)
            for label, extra in SPATIAL_MODELS.items()]
    one = {label: _one_process_frame(device, argv) for label, argv in runs}
    ranks = run_workers(2, spatial_rank, runs, device=[0, 0], backend="gloo", timeout=600,
                        echo=True)
    res, counts = {"seconds": time.perf_counter() - t}, {}
    for label, _ in runs:
        ok, mine = one[label]["decided"], [r[label] for r in ranks]
        for r in mine:
            if not torch.equal(r["label"][ok], one[label]["label"][ok]):
                raise AssertionError(f"--spatial 2 {label} labels != one process's on the "
                                     f"decided pixels")
            check_counts(f"--spatial 2 {label}, a rank's {SPATIAL_FRAMES} b1 frames",
                         r["counts"], {**dict.fromkeys(r["counts"], 0),
                                       "jfa_class": SPATIAL_FRAMES})
        res[label] = {"spatial_ranks": [{k: v for k, v in r.items() if k != "label"}
                                        for r in mine],
                      "one_process": {k: v for k, v in one[label].items()
                                      if k not in ("decided", "label")},
                      "undecided_pixels": int((~ok).sum())}
        if label == "flagship":
            res[label]["phase_3a_b1"] = b1
        log(f"--spatial 2 {label} (two gloo ranks on one card), b1 f32: labels held on "
            f"{int(ok.sum())} decided pixels; wall per frame "
            f"{[round(r['wall_ms'], 2) for r in mine]} ms over two ranks against "
            f"{one[label]['wall_ms']:.2f} ms in one process; exchanges per frame "
            f"{[r['exchanges_per_frame'] for r in mine]}; {json.dumps(res[label])} on {card}")
        key = "spatial_b1_ranks" + ("" if label == "flagship" else f"_{label}")
        counts[key] = {"jfa_class": sum(r["counts"]["jfa_class"] for r in mine)}
    log(f"3h (b) took {res['seconds']:.1f} s")
    return res, counts


def spatial_and_nonsyn_path(card, device, out_dir, b1) -> tuple[dict, dict]:
    """Phase 3h (b) and (c): two ``--spatial`` ranks for the flagship,
    SegFormer-B5 and DeepLabV3-R101 (``spatial_serving``); then the serving
    CLI with ``--mesh 2`` and ``resnet18_nonsyn`` (b8, two gloo ranks on the
    card; no time is read from it) beside one process's model on the CLI's
    frames, at most ``NONSYN_FLIPS`` decided pixels differing. The CLI's
    ``--spatial`` wiring is held on the CPU
    (``tests/test_torch_parallel_spatial*.py``)."""
    import numpy as np
    import torch

    from fovealseg_torch.cli import infer as cli

    common = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--num-batches", "2"]
    opts = SERVE_F32_OPTS
    t = time.perf_counter()
    res, counts = spatial_serving(card, device, b1)

    # (c): the CLI's two ranks start while this process computes the
    # reference on the CLI's frames with one model
    extra = ["MODEL.saliency_net", "resnet18_nonsyn"]
    _, cfg, _ = cli._parse(common + ["--batch", "8"] + opts + extra)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(cli.main, common + ["--batch", "8", "--mesh", "2", "--gpus", "0,0",
                                              "--backend", "gloo", "--out", f"{out_dir}/nonsyn"]
                          + opts + extra)
        model = cli.build_model(cfg, device)
        names, decided, want = [], [], []
        for batch_names, xs, fs in cli.synthetic_batches(2, CANVAS, 8):
            x, f = torch.from_numpy(xs).to(device), torch.from_numpy(fs).to(device)
            with torch.no_grad():
                decided.append(_decided(model.infer(x, f)["pred_sampled"]).cpu().numpy())
                want.append(model.infer(x, f, argmax_labels=True)["pred_label"]
                            .to(torch.uint8).cpu().numpy())
            names += batch_names
        del model
        ranks_summary = fut.result()
    decided, want = np.concatenate(decided), np.concatenate(want)
    got = np.stack([np.load(f"{out_dir}/nonsyn/{n}.mask.npy") for n in names])
    flips = int((got[decided] != want[decided]).sum())
    # the _nonsyn nets' statistics are all-reduced sums over the ranks, which
    # round unlike one process's means, so the grid moves by its last bits and
    # a pixel near a warp cell's edge can take its neighbour's task pixel
    if got.shape != want.shape or flips > NONSYN_FLIPS:
        raise AssertionError(f"--mesh 2 resnet18_nonsyn: {flips} decided pixels differ from one "
                             f"process's labels (at most {NONSYN_FLIPS})")
    counts["nonsyn_cli"] = {"jfa_class": sum(r["launches"]["jfa_class"] for r in ranks_summary)}
    res["nonsyn_cli"] = {"frames": ranks_summary[0]["frames"],
                         "launches": [r["launches"] for r in ranks_summary],
                         "undecided_pixels": int((~decided).sum()),
                         "decided_pixels_differing": flips, "pixels": int(decided.size)}
    torch.cuda.empty_cache()
    log(f"serving CLI --mesh 2 resnet18_nonsyn (b8, two gloo ranks on one card) against one "
        f"process: {json.dumps(res['nonsyn_cli'])}; {time.perf_counter() - t:.1f} s")
    return res, counts


def mesh_and_spatial_path(card, device, out_dir, b1):
    """Phase 3h."""
    import torch

    t = time.perf_counter()
    torch.cuda.empty_cache()
    mesh, counts = mesh_2d_path(card, device, out_dir)
    serving, more = spatial_and_nonsyn_path(card, device, out_dir, b1)
    counts.update(more)
    seconds = time.perf_counter() - t
    log(f"phase 3h took {seconds:.1f} s on {card}")
    return {"mesh_2d": mesh, "spatial": serving, "phase_3h_s": seconds}, counts


# --------------------------------------------------------------- phase 3i

EXPORT_OPTS = ["MODEL.gaussian_radius", "45", "TRAIN.saliency_input_size", "(80,80)",
               "TRAIN.task_input_size", "(80,80)"]
# label: (extra CLI flags, TPU.compute_dtype, the kernels one call launches)
EXPORTS = {"argmax float32": ([], "float32", ("jfa_class",)),
           "argmax bfloat16": ([], "bfloat16", ("jfa_class",)),
           "scores float32": (["--scores"], "float32", ("jfa_relpay", "row_gather"))}
ARTIFACT_CALLS = 5  # timed calls of each program and of the live infer, in turn
# A process that imports fovealseg_torch.ops and nothing else of the repository
# loads one artifact, runs it once and saves what it returns
LOAD_ONLY_OPS = """
import json, sys, time, numpy as np, torch
import fovealseg_torch.ops
from fovealseg_torch.ops import gather, jfa
counters = {"jfa_class": jfa.nearest_class, "jfa_relpay": jfa.nearest_payload_packed,
            "row_gather": gather.row_gather}
x, f = (torch.from_numpy(np.load(p)).cuda() for p in sys.argv[1:3])
t = time.perf_counter()
serve = torch.export.load(sys.argv[3]).module()
load_s = time.perf_counter() - t
with torch.no_grad():
    out = serve(x, f)
torch.cuda.synchronize()
np.save(sys.argv[3] + ".out.npy", out.cpu().numpy())
mods = sorted(m for m in sys.modules if m.startswith(("fovealseg", "jax", "flax")))
print(json.dumps({"launches": {k: c.launches for k, c in counters.items()}, "load_s": load_s,
                  "first_call_s": time.perf_counter() - t - load_s, "modules": mods}))
"""
# The CSAIL semantic-segmentation-pytorch ADE20K configurations (its config/
# ade20k-*.yaml): encoder, decoder, fc_dim; and HRNet-W48 on a Cityscapes frame
ZOO_PAIRS = {"resnet101dilated-ppm_deepsup": ("resnet101dilated", "ppm_deepsup", 2048),
             "mobilenetv2dilated-c1_deepsup": ("mobilenetv2dilated", "c1_deepsup", 320),
             "resnet50-upernet": ("resnet50", "upernet", 2048)}
ADE_HW, CITYSCAPES_HW = (512, 683), (512, 1024)
BUCKET_SIZES = ((512, 683), (1024, 1365))


def frames_hw(batch: int, hw, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, *hw, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(f).to(device)


def call_numbers(fn, n: int) -> dict:
    """Per call of ``fn``: the host clock (median, ending in a synchronise),
    CUDA events around one call (median), and, over ``n`` calls under
    torch.profiler, the device-busy ms and the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.tools.profile_gather import events_ms

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    ev = events_ms(fn, n, warmup=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    wall = statistics.median(walls)
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0) + 1 / n
    return dict(wall_ms=wall, events_ms=ev, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall), kernels_per_call=len(kernels) / n,
                by_name=by_name)


def kernel_difference(a: dict, b: dict, top: int = 8) -> dict:
    """The kernels per call of ``a`` less those of ``b`` ({name: count}), by
    name, the largest differences first."""
    diff = {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}
    return dict(sorted(((k, v) for k, v in diff.items() if v), key=lambda kv: -abs(kv[1]))[:top])


def export_cfg(dtype: str):
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(EXPORT_OPTS + ["TPU.compute_dtype", dtype])
    return cfg


def artifact_path(card, device, out_dir) -> tuple[dict, dict]:
    """Phase 3i (a): the flagship exported through ``cli.export`` (b8,
    640x640, random weights from the config's seed) in f32 and bf16 argmax
    and f32 scores; each program loaded by a process that imports only
    ``fovealseg_torch.ops`` and, in this process, run beside the live
    ``infer`` on the same frames: bit-equal outputs, the operators' launch
    counts, and per call the host clock, CUDA events, device-busy ms and
    kernels. ``--format torch`` read back strictly."""
    import os

    import numpy as np
    import torch

    from fovealseg_torch.cli import export
    from fovealseg_torch.cli.infer import build_model
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.train.checkpoint import load_torch_checkpoint

    x, f = frames(8, CANVAS, SEED + 40, device)
    np.save(f"{out_dir}/x.npy", x.cpu().numpy())
    np.save(f"{out_dir}/f.npy", f.cpu().numpy())
    res, counts_by_path, paths, programs, procs = {}, {}, {}, {}, {}
    t_load = time.perf_counter()
    for label, (flags, dt, _) in EXPORTS.items():
        paths[label] = f"{out_dir}/{label.replace(' ', '_')}.pt2"
        t = time.perf_counter()
        summary = export.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--out",
                               paths[label], "--batch", "8", "--canvas", str(CANVAS),
                               "--allow-random", *flags, *EXPORT_OPTS, "TPU.compute_dtype", dt])
        res[label] = dict(export_s=time.perf_counter() - t, bytes=summary["bytes"],
                          ops=summary["ops"], inputs=summary["inputs"],
                          outputs=summary["outputs"])
        programs[label] = summary["program"]
        log(f"{label}: exported in {res[label]['export_s']:.1f} s (save included)")
        # loaded by its own process while the next program is traced (host work)
        procs[label] = subprocess.Popen([sys.executable, "-c", LOAD_ONLY_OPS, f"{out_dir}/x.npy",
                                         f"{out_dir}/f.npy", paths[label]],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # while the programs load: --format torch, read back strictly into a fresh model
    live = {dt: build_model(export_cfg(dt), device) for dt in ("float32", "bfloat16")}
    ckpt = f"{out_dir}/torch_format"
    export.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--out", ckpt, "--format",
                 "torch", "--allow-random", *EXPORT_OPTS, "TPU.compute_dtype", "float32"])
    back = DeformSegmentation(DeformConfig.from_cfg(export_cfg("float32")), device=device)
    load_torch_checkpoint(back, ckpt, "last", strict=True)
    want, got = live["float32"].state_dict(), back.state_dict()
    if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("--format torch files differ from the model's state dict")
    log(f"--format torch: {len(os.listdir(ckpt))} files loaded back strictly, equal to the "
        f"model's state dict ({len(want)} entries)")
    del back, got
    loaded = {}
    for label, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"loading {label} in a fresh process failed:\n{err}")
        loaded[label] = json.loads(out.strip().splitlines()[-1])
        mods = loaded[label].pop("modules")
        if not all(m == "fovealseg_torch" or m.startswith("fovealseg_torch.ops")
                   for m in mods):
            raise AssertionError(f"the process loading {label} imported {mods}")
    log(f"three processes importing only {mods} loaded and ran the three programs, "
        f"all done {time.perf_counter() - t_load:.1f} s after the first export began")
    for label, (flags, dt, kernels) in EXPORTS.items():
        key = "pred_sampled" if flags else "pred_label"
        model = live[dt]
        want = model.infer(x, f, argmax_labels=not flags)[key]
        sub_out = torch.from_numpy(np.load(paths[label] + ".out.npy"))
        sub = loaded[label]
        sub_counts = sub["launches"]
        if sub_counts != {k: int(k in kernels) for k in sub_counts}:
            raise AssertionError(f"{label}: the loading process counted {sub_counts}")
        program = programs.pop(label).module()
        reset_counts()
        with torch.no_grad():
            got = program(x, f)
            art = call_numbers(lambda: program(x, f), ARTIFACT_CALLS)
        counts = read_counts()
        calls = 2 + 3 * ARTIFACT_CALLS  # two warm-ups, host clock, events, profiled
        check_counts(f"the {label} program", counts,
                     {**dict.fromkeys(counts, 0), **dict.fromkeys(kernels, calls)})
        counts_by_path[f"export_{label.replace(' ', '_')}"] = counts
        for name, out in (("this process", got), ("the loading process", sub_out)):
            if out.shape != want.shape or not torch.equal(out.cpu(), want.cpu()):
                raise AssertionError(f"{label}: the program's output in {name} != live infer")
        live_numbers = call_numbers(lambda: model.infer(x, f, argmax_labels=not flags),
                                    ARTIFACT_CALLS)
        res[label].update(program=art, live=live_numbers, bit_equal=True,
                          loading_process=sub,
                          extra_kernels=kernel_difference(art.pop("by_name"),
                                                          live_numbers.pop("by_name")))
        log(f"{label} b8: program {res[label]['bytes'] / 1e6:.1f} MB, exported in "
            f"{res[label]['export_s']:.1f} s, loaded in {sub['load_s']:.1f} s by the fresh "
            f"process, ops {res[label]['ops']}; per call program "
            f"{json.dumps(art)} | live infer {json.dumps(live_numbers)}; bit-equal on {card}")
        log(f"{label}: kernels per call, program less live, by name: "
            f"{json.dumps(res[label]['extra_kernels'])}")
        del program, got
        os.remove(paths[label])
    del live
    torch.cuda.empty_cache()
    return res, counts_by_path


def zoo_modules(enc, dec, fc_dim, dtype, device):
    import torch

    from fovealseg_torch.models import build_backbone, build_legacy_decoder
    from fovealseg_torch.models.layers import init_weights

    gen = torch.Generator().manual_seed(SEED)
    backbone = init_weights(build_backbone(enc, dtype=dtype), gen)
    decoder = init_weights(build_legacy_decoder(dec, 150, fc_dim, use_softmax=True, dtype=dtype),
                           gen)
    return backbone.to(device).eval(), decoder.to(device).eval()


def zoo_against_host(label, make, x) -> float:
    """The f32 module on the card (TF32 off) against the same weights on the
    host on the small input ``x``: the largest difference over the largest
    magnitude, of every output; at most 1e-4, phase 3e's tolerance."""
    import copy

    import torch

    host = make()
    card = copy.deepcopy(host).cuda()
    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        with torch.no_grad():
            ref, got = host(x), card(x.cuda())
    finally:
        torch.backends.cudnn.conv.fp32_precision = prev
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    err = max(float((g.cpu() - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
    if not err <= 1e-4:
        raise AssertionError(f"{label}: card and host differ by {err:.3g} on the small input")
    return err


def zoo_path(card, device) -> dict:
    """Phase 3i (b): the zoo at published widths on the card, b2 in f32 and
    bf16: the three ADE20K pairs on 512x683 frames (150 classes, the
    decoders' softmax at the frame's size) and SegHRNet-W48 on a 512x1024
    frame (19 classes, logits at 1/4); per call the host clock, device-busy
    ms and kernels; each f32 module against the host on a small input."""
    import numpy as np
    import torch

    from fovealseg_torch.models import get_seg_model
    from fovealseg_torch.models.layers import init_weights

    res = {}
    rng = np.random.default_rng(SEED + 41)
    x_ade = torch.from_numpy(rng.uniform(0, 1, (2, 3, *ADE_HW)).astype(np.float32)).to(device)
    x_city = torch.from_numpy(rng.uniform(0, 1, (2, 3, *CITYSCAPES_HW)).astype(np.float32)
                              ).to(device)
    small = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 80)).astype(np.float32))
    for name, (enc, dec, fc_dim) in ZOO_PAIRS.items():
        for dt in ("float32", "bfloat16"):
            backbone, decoder = zoo_modules(enc, dec, fc_dim, getattr(torch, dt), device)
            with torch.no_grad():
                probs = decoder(backbone(x_ade), ADE_HW)
                numbers = call_numbers(lambda: decoder(backbone(x_ade), ADE_HW), 3)
            numbers.pop("by_name")
            if probs.shape != (2, 150, *ADE_HW) or not torch.isfinite(probs).all() or float(
                    (probs.sum(1) - 1).abs().max()) > 1e-3:
                raise AssertionError(f"{name} {dt}: probabilities {tuple(probs.shape)} wrong")
            numbers["params"] = sum(p.numel() for p in backbone.parameters()) + sum(
                p.numel() for p in decoder.parameters())
            res[f"{name} {dt}"] = numbers
            log(f"zoo {name} {dt} b2 {ADE_HW}: {json.dumps(numbers)} on {card}")
            del backbone, decoder, probs
        def make(enc=enc, dec=dec, fc_dim=fc_dim):
            backbone, decoder = zoo_modules(enc, dec, fc_dim, torch.float32, "cpu")
            decoder.use_softmax = False
            return torch.nn.Sequential(backbone, decoder)
        res[f"{name} card_vs_host"] = zoo_against_host(name, make, small)
    for dt in ("float32", "bfloat16"):
        model = init_weights(get_seg_model(19, dtype=getattr(torch, dt)),
                             torch.Generator().manual_seed(SEED)).to(device).eval()
        with torch.no_grad():
            logits = model(x_city)
            numbers = call_numbers(lambda: model(x_city), 3)
        numbers.pop("by_name")
        if logits.shape != (2, 19, 128, 256) or not torch.isfinite(logits).all():
            raise AssertionError(f"SegHRNet-W48 {dt}: logits {tuple(logits.shape)}")
        numbers["params"] = sum(p.numel() for p in model.parameters())
        res[f"seg_hrnet_w48 {dt}"] = numbers
        log(f"zoo SegHRNet-W48 {dt} b2 {CITYSCAPES_HW}: {json.dumps(numbers)} on {card}")
        del model, logits
    res["seg_hrnet_w48 card_vs_host"] = zoo_against_host(
        "SegHRNet-W48", lambda: init_weights(get_seg_model(19), torch.Generator().manual_seed(
            SEED)).eval(), small)
    log(f"zoo card vs host (TF32 off, small input): "
        f"{json.dumps({k: v for k, v in res.items() if k.endswith('card_vs_host')})}")
    torch.cuda.empty_cache()
    return res


def bucketed_path(card, device) -> tuple[dict, dict]:
    """Phase 3i (c): the flagship's f32 weights served by ``BucketedDeform``
    (``TRAIN.dynamic_task_input (80,80)``) at two raw sizes, b2 each: the
    task geometry of each size, K1 once per call, and the labels bit-equal
    to a host recompute through the plain versions."""
    import torch

    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter
    from fovealseg_torch.models.bucketed import BucketedDeform

    model = flagship(torch.float32, device)
    bucketed = BucketedDeform(model, (80, 80))
    res = {}
    reset_counts()
    outs = {}
    for i, hw in enumerate(BUCKET_SIZES):
        x, f = frames_hw(2, hw, SEED + 42 + i, device)
        outs[hw] = bucketed.infer(x, f, argmax_labels=True)
        t = time.perf_counter()
        bucketed.infer(x, f, argmax_labels=True)
        torch.cuda.synchronize()
        res[f"{hw[0]}x{hw[1]}"] = dict(task_hw=list(bucketed.module_for(hw).config.task_hw),
                                       wall_ms=(time.perf_counter() - t) * 1e3)
    counts = read_counts()
    check_counts("BucketedDeform", counts,
                 {**dict.fromkeys(counts, 0), "jfa_class": 2 * len(BUCKET_SIZES)})
    for hw, out in outs.items():
        label, grid = out["pred_label"], out["grid"]
        if label.shape != (2, *hw):
            raise AssertionError(f"BucketedDeform {hw}: labels {tuple(label.shape)}")
        rounds = jfa_rounds_from_grid(grid, hw)
        host = unwarp_argmax_scatter(out["pred"].cpu(), grid.cpu(), hw, rounds=rounds.cpu())
        if not torch.equal(host, label.cpu()):
            raise AssertionError(f"BucketedDeform {hw}: labels != the host recompute")
    log(f"BucketedDeform: {json.dumps(res)}; labels bit-equal to the host recompute through "
        f"the plain jump flood on {card}")
    del model, bucketed, outs
    torch.cuda.empty_cache()
    return res, {"bucketed": counts}


def dispatch_cost(card, device) -> dict:
    """Phase 3i (a): what the registered operator costs per call on this
    host: CUDA events around one call on an idle stream (median of 20) of K1
    at b8 640x640 and K5 at C = 1 (the label round trip's gather), through
    the wrapper (the operator) and through the operator's CUDA kernel
    function called directly, in turn, three times each."""
    import torch

    from fovealseg_torch.ops import gather, jfa
    from fovealseg_torch.tools.profile_gather import events_ms

    g = torch.Generator(device=device).manual_seed(SEED)
    valid = torch.rand((8, CANVAS, CANVAS), generator=g, device=device) > 0.995
    payload = torch.randint(0, 51, (8, CANVAS, CANVAS), generator=g, device=device,
                            dtype=torch.int32)
    rounds = torch.full((1,), 7, dtype=torch.int32, device=device)
    table = torch.randn((8, 6400, 1), generator=g, device=device)
    idx = torch.randint(0, 6400, (8, CANVAS, CANVAS), generator=g, device=device,
                        dtype=torch.int32)
    pairs = {"jfa_class": (lambda: jfa.nearest_class(valid, payload, 6, rounds),
                           lambda: jfa._launch("fovealseg_jfa_nearest_payload", valid, payload,
                                               rounds, "nearest_class")),
             "row_gather C=1": (lambda: gather.row_gather(table, idx),
                                lambda: gather._row_gather_cuda(table, idx))}
    res = {}
    for name, (wrapper, direct) in pairs.items():
        runs = {"wrapper": [], "direct": []}
        for _ in range(3):
            runs["wrapper"].append(events_ms(wrapper, 20))
            runs["direct"].append(events_ms(direct, 20))
        res[name] = {k: statistics.median(v) for k, v in runs.items()}
        res[name]["operator_us"] = (res[name]["wrapper"] - res[name]["direct"]) * 1e3
    log(f"the registered operators' cost per call (events ms, one call on an idle stream): "
        f"{json.dumps(res)} on {card}")
    return res


def export_and_zoo_path(card, device, out_dir) -> tuple[dict, dict]:
    """Phase 3i."""
    t = time.perf_counter()
    artifact, counts = artifact_path(card, device, out_dir)
    t_zoo = time.perf_counter()
    zoo = zoo_path(card, device)
    t_bucket = time.perf_counter()
    bucketed, more = bucketed_path(card, device)
    counts.update(more)
    artifact["operator_cost"] = dispatch_cost(card, device)
    seconds = {"artifact": t_zoo - t, "zoo": t_bucket - t_zoo,
               "bucketed_and_operator_cost": time.perf_counter() - t_bucket}
    log(f"phase 3i took {sum(seconds.values()):.1f} s ({json.dumps(seconds)}) on {card}")
    return {"artifact": artifact, "zoo": zoo, "bucketed": bucketed, "phase_3i_s": seconds}, counts


# --------------------------------------------------------------- phase 3j

SAMPLER_HW = (80, 80)  # the flagship's task size
SAMPLER_KERNEL = 65  # deformed_sampler.get_grid's default window


def host_remainder_path(card, device) -> tuple[dict, dict]:
    """Phase 3j: the host-only remainder on the card at the flagship's
    geometry. The DynamicFocus sampler: ``get_grid`` on a [8, 144, 144, 1]
    deformation map (80x80 sample, kernel 65; with TF32 allowed, which its
    full-f32 products must ignore) against the host's f32 result within
    1e-5; ``int_round_scale_grid`` to 640x640 equal to the host's on the
    same grid; ``deformed_unsampler`` of [8, 80, 80, 51] f32 values to
    640x640, its launches counted (K4 and K5 once each), each held bit-equal
    to its plain version on the inputs the call gave it, the output
    bit-equal to the host's recompute through the plain versions, timed in
    CUDA events and torch.profiler device ms. ``interp2d_apply``'s gradient
    on the card against the host's (within 1e-5; the blend's backward
    accumulates in another order), and ``device_memory_stats()``."""
    import numpy as np
    import torch

    from fovealseg_torch.core import deformed_sampler as ds
    from fovealseg_torch.native.interp2d import build_interp_plan, interp2d_apply
    from fovealseg_torch.tools.profile_gather import device_ms, events_ms
    from fovealseg_torch.utils.observe import device_memory_stats

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 40)
    hs, ws = SAMPLER_HW
    pad = SAMPLER_KERNEL // 2
    dm = torch.from_numpy(rng.uniform(0, 1, (8, hs + 2 * pad, ws + 2 * pad, 1)).astype(np.float32))
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        dm_card = dm.to(device)
        grid = ds.get_grid(dm_card, SAMPLER_HW, SAMPLER_KERNEL)
        torch.cuda.synchronize()
        grid_ms = events_ms(lambda: ds.get_grid(dm_card, SAMPLER_HW, SAMPLER_KERNEL), 10)
    finally:
        matmul.fp32_precision = prev
    host_grid = ds.get_grid(dm, SAMPLER_HW, SAMPLER_KERNEL)
    grid_err = (grid.cpu() - host_grid).abs().max().item()
    if not grid_err <= 1e-5:
        raise AssertionError(f"get_grid on the card is {grid_err} from the host's f32 result")
    ig = ds.int_round_scale_grid(host_grid, (CANVAS, CANVAS))
    if not torch.equal(ds.int_round_scale_grid(host_grid.to(device), (CANVAS, CANVAS)).cpu(), ig):
        raise AssertionError("int_round_scale_grid on the card differs from the host's")
    ig_card = ds.int_round_scale_grid(grid, (CANVAS, CANVAS))
    moved = (ig_card.cpu() != ig).any(-1).sum().item()

    values = torch.from_numpy(rng.standard_normal((8, hs, ws, 51)).astype(np.float32))
    v_card = values.to(device)
    ig_card = ig.to(device)
    torch.cuda.synchronize()
    reset_counts()
    with kernel_inputs({"jfa_seed": "nearest_seed", "row_gather": "row_gather"}) as seen:
        out = ds.deformed_unsampler(v_card, ig_card, (CANVAS, CANVAS))
    counts = read_counts()
    check_counts("deformed_unsampler [8, 80, 80, 51] -> 640x640", counts,
                 {**dict.fromkeys(counts, 0), "jfa_seed": 1, "row_gather": 1})
    hold_on_path_inputs("deformed_unsampler", seen, ("jfa_seed", "row_gather"))
    host = ds.deformed_unsampler(values, ig, (CANVAS, CANVAS))
    if not torch.equal(out.cpu().view(torch.int32), host.view(torch.int32)):
        raise AssertionError("deformed_unsampler on the card != the host's plain recompute")
    landed = seen["jfa_seed"][0].float().mean().item()

    def call():
        return ds.deformed_unsampler(v_card, ig_card, (CANVAS, CANVAS))

    unsampler = dict(ms=events_ms(call, 20), device_ms=device_ms(call, 20)[0],
                     landed_share=landed)

    pts = np.argwhere(rng.uniform(0, 1, (hs, ws)) > 0.9).astype(np.float64)
    pts = np.concatenate([pts, [[0, 0], [0, ws - 1], [hs - 1, 0], [hs - 1, ws - 1]]])
    corner, weight = build_interp_plan(pts, hs, ws)
    vals = torch.from_numpy(rng.standard_normal((len(pts), 51)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((hs * ws, 51)).astype(np.float32))
    grads = []
    for dev in (device, torch.device("cpu")):
        v = vals.to(dev).requires_grad_(True)
        (interp2d_apply(v, corner, weight) * cot.to(dev)).sum().backward()
        grads.append(v.grad.cpu())
    interp_err = (grads[0] - grads[1]).abs().max().item()
    if not interp_err <= 1e-5:
        raise AssertionError(f"interp2d_apply's gradient on the card is {interp_err} from the host's")
    mem = device_memory_stats()
    res = dict(get_grid_max_abs_err=grid_err, get_grid_ms=grid_ms, int_grid_pixels_moved=moved,
               deformed_unsampler=unsampler, interp2d_grad_max_abs_err=interp_err,
               device_memory_stats=mem, phase_3j_s=time.perf_counter() - t_phase)
    log(f"phase 3j: get_grid [8, 144, 144, 1] card vs host max abs err {grid_err:.3g} "
        f"({grid_ms:.4f} ms events; {moved} of {8 * hs * ws} snapped pixels move with the card's "
        f"grid); int_round_scale_grid equal; deformed_unsampler [8, 80, 80, 51] -> 640x640 "
        f"bit-equal to the host's plain recompute, {unsampler['ms']:.4f} ms events, "
        f"{unsampler['device_ms']:.4f} ms device, {landed:.4f} of the canvas landed; "
        f"interp2d_apply gradient max abs err {interp_err:.3g}; device_memory_stats "
        f"{json.dumps(mem)}; {res['phase_3j_s']:.1f} s on {card}")
    return res, {"deformed_sampler": counts}


# --------------------------------------------------------------- phase 3k

W8A8_OPTS = ["TPU.quantize", "int8"]
# the K8 shapes timed (the flagship's b8 call): (label, cin, hw, cout, k, stride, padding,
# dtype); the last is the kernels line's row (C1's cbr input, the path's largest conv, in
# f32, the dtype PyTorch's quantize_per_tensor takes)
W8A8_TIMED = (("hrnet 3x3 128 @ 40x40", 128, 40, 128, 3, 1, 1, "bfloat16"),
              ("hrnet 3x3 256 @ 20x20", 256, 20, 256, 3, 1, 1, "bfloat16"),
              ("hrnet 3x3 512 @ 10x10", 512, 10, 512, 3, 1, 1, "bfloat16"),
              ("c1 cbr 3x3 960->240 @ 80x80", 960, 80, 240, 3, 1, 1, "bfloat16"),
              ("c1 cbr 3x3 960->240 @ 80x80 f32", 960, 80, 240, 3, 1, 1, "float32"))
INT8_TOPS = 1979e12  # H100 SXM dense int8, data sheet


def quant_counters():
    from fovealseg_torch.ops import quant

    return {"absmax_scale": quant.absmax_scale, "quantize_act": quant.quantize_act,
            "int8_conv2d": quant.int8_conv2d}


def reset_quant_counts():
    for fn in quant_counters().values():
        fn.launches = 0


def read_quant_counts():
    import torch

    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in quant_counters().items()}


def hold_w8a8(label, args) -> None:
    """K6, K7 and K8 on one conv's inputs against their plain versions, on
    the card, and the path's one-call W8A8 conv against them: bit-equal (int
    views). Not counted as the path's launches."""
    import torch

    from fovealseg_torch.ops import quant

    x, weight_q, w_scale, bias, stride, padding = args
    s_k, s_p = quant.absmax_scale(x), quant.absmax_scale_plain(x)
    q_k, q_p = quant.quantize_act(x, s_k), quant.quantize_act_plain(x, s_p)
    y_k = quant.int8_conv2d(q_k, weight_q, s_k, w_scale, bias, stride, padding, x.dtype)
    y_p = quant.int8_conv2d_plain(q_p, weight_q, s_p, w_scale, bias, stride, padding, x.dtype)
    y_f = quant.w8a8_conv2d(x, weight_q, w_scale, bias, stride, padding)
    torch.cuda.synchronize()
    bits = torch.int16 if y_k.element_size() == 2 else torch.int32
    if not (torch.equal(s_k.view(torch.int32), s_p.view(torch.int32)) and torch.equal(q_k, q_p)
            and torch.equal(y_k.view(bits), y_p.view(bits))
            and torch.equal(y_f.view(bits), y_p.view(bits))):
        raise AssertionError(f"K6/K7/K8 != plain on {label}")


def w8a8_bounds(x, weight_q, stride, padding) -> dict:
    """The least times of K6, K7 and K8 at one conv (bytes over 3.35 TB/s;
    K8 the larger of that and 2*M*N*K over 1,979 TOPS)."""
    b, c, h, w = x.shape
    n, k = weight_q.shape[:2]
    ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    act, codes, out = x.numel() * x.element_size(), x.numel(), b * n * ho * wo * x.element_size()
    ops = 2 * b * ho * wo * n * k * k * c
    k8_bytes = codes + weight_q.numel() + out + 4 * n + 4
    return {"absmax_scale": (act + 4) / HBM_BYTES_PER_S * 1e3,
            "quantize_act": (act + codes + 4) / HBM_BYTES_PER_S * 1e3,
            "int8_conv2d": max(k8_bytes / HBM_BYTES_PER_S, ops / INT8_TOPS) * 1e3,
            "int8_conv2d_by": "operations" if ops / INT8_TOPS > k8_bytes / HBM_BYTES_PER_S
            else "bytes", "gop": ops / 1e9}


def time_w8a8_shape(card, device, label, cin, hw, cout, k, stride, padding, dtype) -> dict:
    """K6, K7 and K8 at one shape of the flagship's b8 call (random
    activations and weights from a seed), held bit-equal and timed by
    ``hold`` beside yardsticks the port never calls: for K6
    ``torch.linalg.vector_norm(x, inf)`` (max |x|); for K7
    ``torch.quantize_per_tensor`` of a channels_last x (the NHWC codes; f32
    only, PyTorch quantizes no bf16 tensor); for K8 ``torch._int_mm`` of the
    codes' ``F.unfold`` (the product alone, the ``library`` time, and with
    the unfold) and cuDNN's bf16 conv of the same shape. Also the path's
    one-call W8A8 conv (K6 -> K7 -> K8) in events beside the three calls."""
    import torch
    import torch.nn.functional as F

    from fovealseg_torch.models.layers import quantize_kernel
    from fovealseg_torch.ops import quant
    from fovealseg_torch.tools.profile_gather import events_ms

    g = torch.Generator().manual_seed(cin + hw)
    x = torch.relu(torch.randn(8, cin, hw, hw, generator=g)).to(getattr(torch, dtype)).to(device)
    wt = torch.randn(cout, cin, k, k, generator=g) * (2.0 / (cin * k * k)) ** 0.5
    codes, w_scale = quantize_kernel(wt.to(device))
    weight_q = codes.permute(0, 2, 3, 1).contiguous()
    s_x = quant.absmax_scale(x)
    xq = quant.quantize_act(x, s_x)
    bounds = w8a8_bounds(x, weight_q, stride, padding)
    k7_libraries = {}
    if x.dtype == torch.float32:
        x_cl, s_host = x.contiguous(memory_format=torch.channels_last), s_x.item()
        k7_libraries["torch.quantize_per_tensor"] = lambda: torch.quantize_per_tensor(
            x_cl, s_host, 0, torch.qint8)
    else:
        log(f"W8A8 {label}: no K7 yardstick: torch.quantize_per_tensor takes only float32")
    res = {"absmax_scale": hold("absmax_scale", label, lambda: quant.absmax_scale(x),
                                lambda: quant.absmax_scale_plain(x), bounds["absmax_scale"],
                                {"torch.linalg.vector_norm(inf)": lambda: torch.linalg.vector_norm(
                                    x, ord=math.inf)}, n=10),
           "quantize_act": hold("quantize_act", label, lambda: quant.quantize_act(x, s_x),
                                lambda: quant.quantize_act_plain(x, s_x), bounds["quantize_act"],
                                k7_libraries, n=10)}
    ho = (hw + 2 * padding - k) // stride + 1
    x_nchw = xq.permute(0, 3, 1, 2).to(torch.bfloat16)
    cols = F.unfold(x_nchw, k, padding=padding, stride=stride).to(torch.int8)
    a = cols.transpose(1, 2).reshape(8 * ho * ho, cin * k * k).contiguous()
    bmat = codes.reshape(cout, -1).t().contiguous()
    xb, wb = x.to(torch.bfloat16), wt.to(device, torch.bfloat16)

    def unfold_int_mm():
        c = F.unfold(x_nchw, k, padding=padding, stride=stride).to(torch.int8)
        return torch._int_mm(c.transpose(1, 2).reshape(8 * ho * ho, -1), bmat)

    libraries = {"torch._int_mm": lambda: torch._int_mm(a, bmat),
                 "F.unfold + torch._int_mm": unfold_int_mm,
                 "cudnn bf16 conv": lambda: F.conv2d(xb, wb, stride=stride, padding=padding)}
    for name, fn in list(libraries.items()):
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:  # a yardstick the installed PyTorch does not run
            log(f"W8A8 {label}: yardstick {name} not run: {e}")
            del libraries[name]
    res["int8_conv2d"] = hold(
        "int8_conv2d", label,
        lambda: quant.int8_conv2d(xq, weight_q, s_x, w_scale, None, stride, padding, x.dtype),
        lambda: quant.int8_conv2d_plain(xq, weight_q, s_x, w_scale, None, stride, padding,
                                        x.dtype),
        bounds["int8_conv2d"], libraries, n=10, bound_by=bounds["int8_conv2d_by"])
    res["int8_conv2d"].update(bound_by=bounds["int8_conv2d_by"], gop=bounds["gop"],
                              tops=bounds["gop"] / res["int8_conv2d"]["loop_ms"])

    def three_calls():
        s = quant.absmax_scale(x)
        return quant.int8_conv2d(quant.quantize_act(x, s), weight_q, s, w_scale, None, stride,
                                 padding, x.dtype)

    one_call = events_ms(lambda: quant.w8a8_conv2d(x, weight_q, w_scale, None, stride, padding),
                         10)
    three = events_ms(three_calls, 10)
    res["int8_conv2d"].update(w8a8_conv2d_ms=one_call, three_calls_ms=three)
    log(f"W8A8 {label}: K8 {res['int8_conv2d']['ms']:.4f} ms events, "
        f"{res['int8_conv2d']['loop_ms']:.4f} back to back ({res['int8_conv2d']['tops']:.1f} "
        f"TOPS of 1,979), bound {bounds['int8_conv2d']:.4f} ms ({bounds['int8_conv2d_by']}); "
        f"K6 -> K7 -> K8 in one call {one_call:.4f} ms events, in three calls {three:.4f} ms; "
        f"on {card}")
    del a, cols
    return res


def w8a8_path(card, device) -> tuple[dict, dict, dict]:
    """Phase 3k: W8A8 serving (``TPU.quantize int8``) at full flagship width.

    K6, K7 and K8 held bit-equal to their plain versions and timed at the
    flagship's four main conv shapes (``W8A8_TIMED``, C1's in bf16 and f32),
    each beside its yardsticks and the path's one-call W8A8 conv (one
    operator, one host call launching K6, K7 and K8); the serving CLI at b8
    bf16 with ``TPU.quantize int8`` (2 batches), then ``infer(argmax_labels=
    True)`` at b8 and b1 in f32 and bf16 on the quantized flagship, the
    counts zeroed just before and read just after: K6, K7 and K8 once per
    quantized conv per call; b8 device busy, idle share and kernels per call
    (torch.profiler) of W8A8 and float serving; on the path's own inputs
    (recorded by forward hooks) each distinct conv shape held bit-equal; a
    b2 served bf16 call's every quantized conv recomputed on the host
    through the plain versions (bit-equal) and its labels
    recomputed on the host from its logits and grid through the plain flood
    (bit-equal); the share of b8 labels where W8A8 and float serving agree
    and their b8 events ms; one eval-CLI b8 bf16 batch with ``TPU.quantize
    int8``."""
    import torch

    from fovealseg_torch.cli import eval as eval_cli
    from fovealseg_torch.cli import infer as cli
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter
    from fovealseg_torch.models.layers import quantize_model
    from fovealseg_torch.ops import quant
    from fovealseg_torch.tools.profile_gather import device_ms, events_ms
    from fovealseg_torch.tools.profile_quant import w8a8_inputs

    log(f"profiler clock probe: {json.dumps(profiler_clock_probe())}")
    t_phase = time.perf_counter()
    numbers = {name: [] for name in quant_counters()}
    for shape in W8A8_TIMED:
        for name, r in time_w8a8_shape(card, device, *shape).items():
            numbers[name].append({"label": shape[0], **r})
    torch.cuda.empty_cache()
    log(f"W8A8 kernels timed at {len(W8A8_TIMED)} shapes in {time.perf_counter() - t_phase:.1f} s")

    models = {"float32": flagship(torch.float32, device),
              "bfloat16": flagship(torch.bfloat16, device)}
    x8, f8 = frames(8, CANVAS, SEED + 50, device)
    float_b8 = {dt: events_ms(lambda m=m: m.infer(x8, f8, argmax_labels=True), 5, warmup=2)
                for dt, m in models.items()}
    float_labels = {dt: m.infer(x8, f8, argmax_labels=True)["pred_label"]
                    for dt, m in models.items()}
    busy = {("float", dt): device_ms(lambda m=m: m.infer(x8, f8, argmax_labels=True), 2)
            for dt, m in models.items()}
    convs = {dt: quantize_model(m) for dt, m in models.items()}
    if len(set(convs.values())) != 1:
        raise AssertionError(f"quantize_model counts differ between dtypes: {convs}")
    n_q = convs["float32"]

    reset_quant_counts()
    reset_counts()
    t = time.perf_counter()
    summary = cli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--batch", "8",
                        "--num-batches", "2", "MODEL.gaussian_radius", "45",
                        "TRAIN.saliency_input_size", "(80,80)", "TRAIN.task_input_size",
                        "(80,80)", "TPU.compute_dtype", "bfloat16"] + W8A8_OPTS)
    calls = 2
    if summary["quantized_convs"] != n_q:
        raise AssertionError(f"the CLI quantized {summary['quantized_convs']} convs, "
                             f"quantize_model {n_q}")
    log(f"W8A8 cli served 2 b8 batches in {time.perf_counter() - t:.1f} s (model build "
        f"included): {summary['fps']:.2f} fps, {n_q} quantized convs")
    timings = {}
    for dt, m in models.items():
        tm, n = time_infer(m, device, n8=5, n1=10, argmax_labels=True)
        timings[dt] = {**tm, "float_b8_ms": float_b8[dt]}
        calls += n
        log(f"W8A8 serving {dt}: b8 {tm['b8_ms']:.3f} ms/batch = {tm['b8_fps']:.1f} fps "
            f"(float {float_b8[dt]:.3f} ms); b1 {tm['b1_ms']:.3f} ms (events), "
            f"{tm['b1_host_ms']:.3f} ms (host clock)")
    agree = {}
    with w8a8_inputs(models.values()) as seen:
        for dt, m in models.items():
            lab = m.infer(x8, f8, argmax_labels=True)["pred_label"]
            calls += 1
            agree[dt] = (lab == float_labels[dt]).float().mean().item()
    counts = read_quant_counts()
    check_counts("the W8A8 path (CLI + infer)", counts, dict.fromkeys(counts, calls * n_q))
    other = read_counts()
    check_counts("the W8A8 path's jump floods", other,
                 {**dict.fromkeys(other, 0), "jfa_class": calls})
    for key, args in seen.items():
        hold_w8a8(f"W8A8 path conv {key[:3]}", args)
    log(f"W8A8 path: K6, K7 and K8 bit-equal to their plain versions on {len(seen)} distinct "
        f"conv shapes' own inputs; b8 label agreement with float serving {json.dumps(agree)}")
    busy.update({("w8a8", dt): device_ms(lambda m=m: m.infer(x8, f8, argmax_labels=True), 2)
                 for dt, m in models.items()})
    for (mode, dt), (dev_ms, per_call, names) in busy.items():
        wall = timings[dt]["b8_ms" if mode == "w8a8" else "float_b8_ms"]
        timings[dt][f"{mode}_b8_device_busy_ms"] = dev_ms
        timings[dt][f"{mode}_b8_kernels_per_call"] = per_call
        timings[dt][f"{mode}_b8_idle_share"] = 1.0 - dev_ms / wall
        log(f"{mode} b8 {dt}: device busy {dev_ms:.3f} ms of {wall:.3f} ms (events), idle share "
            f"{1.0 - dev_ms / wall:.3f}, {per_call:.1f} kernels per call")
        if mode == "w8a8":  # K8 by its kernel's name (csrc/quant.cu::int8_conv_wgmma)
            k8_ms = sum(v for k, v in names.items() if k.startswith("int8_conv"))
            timings[dt]["w8a8_b8_k8_device_ms"] = k8_ms
            timings[dt]["w8a8_b8_k8_busy_share"] = k8_ms / dev_ms if dev_ms else None
            log(f"W8A8 b8 {dt}: K8 {k8_ms:.3f} ms device per call, "
                f"{k8_ms / dev_ms if dev_ms else float('nan'):.3f} of W8A8 device busy")

    # a b2 served bf16 call: every quantized conv and the labels recomputed on the host
    log(f"W8A8 path checked at {time.perf_counter() - t_phase:.1f} s into phase 3k")
    x2, f2 = frames(2, CANVAS, SEED + 51, device)
    host_convs = 0
    for dt, m in (("bfloat16", models["bfloat16"]),):
        with w8a8_inputs([m], keep_all=True) as every:
            served = m.infer(x2, f2, argmax_labels=True)
        if len(every) != n_q:
            raise AssertionError(f"b2 {dt}: {len(every)} W8A8 convs ran, expected {n_q}")
        for i, (args, out) in every.items():
            x_h, wq_h, ws_h, b_h, st, pad = (a.cpu() if torch.is_tensor(a) else a for a in args)
            s_h = quant.absmax_scale_plain(x_h)
            ref = quant.int8_conv2d_plain(quant.quantize_act_plain(x_h, s_h), wq_h, s_h, ws_h,
                                          b_h, st, pad, x_h.dtype)
            bits = torch.int16 if ref.element_size() == 2 else torch.int32
            if not torch.equal(out.cpu().view(bits), ref.view(bits)):
                raise AssertionError(f"b2 {dt}: W8A8 conv {i} on the card != the host's plain "
                                     f"recompute")
        host_convs += len(every)
        grid = served["grid"]
        rounds = jfa_rounds_from_grid(grid, (CANVAS, CANVAS)).cpu()
        host = unwarp_argmax_scatter(served["pred"].cpu(), grid.cpu(), (CANVAS, CANVAS),
                                     rounds=rounds)
        if not torch.equal(host, served["pred_label"].cpu()):
            raise AssertionError(f"b2 {dt}: served W8A8 labels != the host recompute")
        label = served["pred_label"]
        if label.shape != (2, CANVAS, CANVAS) or int(label.min()) < 0 or int(label.max()) >= 51:
            raise AssertionError(f"b2 {dt}: pred_label malformed")
    log(f"W8A8 b2 served bf16 call: all {host_convs} quantized convs bit-equal to the host's "
        f"plain recompute, labels bit-equal to the host's plain flood "
        f"({time.perf_counter() - t_phase:.1f} s into phase 3k)")
    del models, seen
    torch.cuda.empty_cache()

    reset_quant_counts()
    result = eval_cli.main(EVAL_FLAGS + ["--num-batches", "1"] + EVAL_OPTS
                           + ["VAL.batch_size", "8", "VAL.y_sampled_reverse", "True"] + W8A8_OPTS)
    eval_counts = read_quant_counts()
    check_counts("the W8A8 eval CLI (1 b8 batch)", eval_counts, dict.fromkeys(eval_counts, n_q))
    check_result("W8A8 eval b8", result, 1)
    result = {k: v for k, v in result.items() if k != "per_class_iou"}
    log(f"W8A8 eval b8 bf16: {json.dumps(result)}")

    res = {"quantized_convs": n_q, "serving": timings, "cli_fps": summary["fps"],
           "label_agreement_with_float": agree, "eval": result,
           "phase_3k_s": time.perf_counter() - t_phase}
    log(f"phase 3k took {res['phase_3k_s']:.1f} s on {card}")
    return numbers, {"w8a8": counts, "w8a8_eval": eval_counts}, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1

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
    numbers = {"jfa_class": check_jfa(model32, device)}
    numbers.update(check_new_kernels(model32, device))
    torch.cuda.empty_cache()

    log("== phase 3a: main path, argmax serving")
    serving, argmax_counts = argmax_path(model32, model16, device)
    small_label_agreement = check_small_against_host(device)
    log("== phase 3b: main path, score maps and round trips")
    scoremap, scoremap_counts, checks = scoremap_path(model32, model16, device)
    checks.update(check_small_scoremap_against_host(device))
    log("== phase 3c: eval")
    with tempfile.TemporaryDirectory() as out_dir:
        eval_counts, eval_other_counts, evaluation = eval_path(card, model16, device, out_dir)
    del model32, model16
    torch.cuda.empty_cache()
    log("== phase 3d: training")
    with tempfile.TemporaryDirectory() as out_dir:
        train_numbers, train_counts, training = train_path(card, device, out_dir)
    numbers.update(train_numbers)
    log("== phase 3e: the SegFormer-B5 and DeepLabV3-R101 encoders, the ResNetZoom saliency nets")
    with tempfile.TemporaryDirectory() as out_dir:
        encoders, encoder_counts = encoders_path(card, device, out_dir)
    log("== phase 3f: data parallelism")
    with tempfile.TemporaryDirectory() as out_dir:
        parallel, parallel_counts = parallel_path(card, device, out_dir)
    log("== phase 3g: real data (cooked LVIS: cook, train, eval; the ADE20K ODGT evaluation)")
    with tempfile.TemporaryDirectory() as out_dir:
        real_data, real_counts, real_numbers = real_data_path(
            card, device, out_dir, training["train"]["float32"]["samples_per_s"])
    log("== phase 3h: the 2-D mesh and spatial serving")
    with tempfile.TemporaryDirectory() as out_dir:
        mesh_spatial, mesh_counts = mesh_and_spatial_path(
            card, device, out_dir, {k: serving["float32"][k] for k in ("b1_ms", "b1_host_ms")})
    log("== phase 3i: the serving artifact (cli.export), the plain-segmentation zoo, "
        "BucketedDeform")
    with tempfile.TemporaryDirectory() as out_dir:
        export_zoo, export_counts = export_and_zoo_path(card, device, out_dir)
    log("== phase 3j: the host-only remainder on the card (the DynamicFocus sampler, "
        "interp2d_apply's gradient, device_memory_stats)")
    remainder, remainder_counts = host_remainder_path(card, device)
    log("== phase 3k: W8A8 int8 serving (TPU.quantize int8: K6, K7, K8)")
    w8a8_numbers, w8a8_counts, w8a8 = w8a8_path(card, device)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("== phase 4: summary")
    meta = {
        "jfa_class": ("fovealseg_torch/csrc/jfa.cu", "fovealseg_tpu/ops/pallas_jfa.py:209"),
        "jfa_relpay": ("fovealseg_torch/csrc/jfa.cu", "fovealseg_tpu/ops/pallas_jfa.py:226"),
        "jfa_payload": ("fovealseg_torch/csrc/jfa.cu", "fovealseg_tpu/ops/pallas_jfa.py:194"),
        "jfa_seed": ("fovealseg_torch/csrc/jfa.cu", "fovealseg_tpu/ops/pallas_jfa.py:186"),
        "row_gather": ("fovealseg_torch/csrc/gather.cu", "fovealseg_tpu/ops/pallas_gather.py:78"),
        # no TPU kernel: the scatter-add that JAX's autodiff makes of the flat gather
        "row_gather_backward": ("fovealseg_torch/csrc/gather.cu",
                                "fovealseg_tpu/core/unwarp.py:31"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        n = numbers[name]
        by_path = {"argmax": argmax_counts[name], "scoremap": scoremap_counts[name],
                   "eval": eval_counts[name], "eval_b2_configs": eval_other_counts[name],
                   "train": train_counts[name],
                   **{path: c[name] for path, c in encoder_counts.items()},
                   **{path: c.get(name, 0) for path, c in parallel_counts.items()},
                   **{path: c[name] for path, c in real_counts.items()},
                   **{path: c.get(name, 0) for path, c in mesh_counts.items()},
                   **{path: c[name] for path, c in export_counts.items()},
                   **{path: c[name] for path, c in remainder_counts.items()}}
        launches = sum(by_path.values())
        if launches == 0:
            raise AssertionError(f"{name} was launched no time on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": n["max_abs_err"], "bit_equal": n["bit_equal"], "ms": n["ms"],
            "kernel_ms": n["ms"], "device_ms": n["device_ms"], "loop_ms": n["loop_ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"], "bound_by": "bytes",
            "library_ms": n["library_ms"], "libraries": n["libraries"], "rounds": n.get("rounds"),
        })
        odgt = {label: {k: v for k, v in r.items() if k != "libraries"}
                for label, r in real_numbers.items()
                if label.startswith({"jfa_relpay": "jfa_relpay", "row_gather": "row_gather"}
                                    .get(name, "-"))}
        if odgt:
            kernels[-1]["odgt"] = odgt
        if "trips" in n:
            kernels[-1]["launches_per_call"] = n["trips"]["launches_per_call"]
        if "launches_per_call" in n:
            kernels[-1]["launches_per_call"] = n["launches_per_call"]
        if "cases" in n:
            kernels[-1]["cases"] = [{k: c[k] for k in ("label", "channels", "variant", "ms",
                                                       "device_ms", "loop_ms", "plain_ms",
                                                       "bound_ms", "libraries", "max_abs_err",
                                                       "library_ms", "kernels_per_call",
                                                       "index_put_deterministic_repeats")
                                     if k in c}
                                    for c in n["cases"]]
    for name in quant_counters():
        cases = w8a8_numbers[name]
        n = cases[-1]  # C1's cbr input in f32, the path's largest conv
        by_path = {path: c[name] for path, c in w8a8_counts.items()}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"{name} was launched no time on the W8A8 path")
        kernels.append({
            "name": name, "route": "cuda", "source": "fovealseg_torch/csrc/quant.cu",
            # no TPU kernel: XLA's int8 conv in TorchConv's W8A8 branch
            "replaces": "fovealseg_tpu/models/layers.py:202",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": n["max_abs_err"], "bit_equal": n["bit_equal"], "ms": n["ms"],
            "kernel_ms": n["ms"], "device_ms": n["device_ms"], "loop_ms": n["loop_ms"],
            "plain_ms": n["plain_ms"], "bound_ms": n["bound_ms"],
            "bound_by": n.get("bound_by", "bytes"), "library_ms": n["library_ms"],
            "libraries": n["libraries"],
            "cases": [{k: c[k] for k in ("label", "ms", "device_ms", "loop_ms", "plain_ms",
                                         "bound_ms", "library_ms", "libraries", "tops")
                       if k in c} for c in cases],
        })
    log(json.dumps({"serving": serving, "scoremap": scoremap, "eval": evaluation, **training,
                    "encoders": encoders, "parallel": parallel, "real_data": real_data,
                    "mesh_and_spatial": mesh_spatial, "export_and_zoo": export_zoo,
                    "host_remainder": remainder, "w8a8": w8a8,
                    "small_input_label_agreement": small_label_agreement,
                    "dropped_profiler_reads": DROPPED_READS, **checks}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _tiny_pair(device, **overrides):
    """The tiny encoder on a 64x64 canvas: the same weights on the host and
    on the card."""
    import torch

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny",
                       **overrides)
    host = init_weights(DeformSegmentation(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    card = DeformSegmentation(cfg, device=device)
    card.load_state_dict(host.state_dict())
    return host, card


def check_small_against_host(device) -> float:
    """The tiny encoder on a 64x64 canvas, same weights on the card (f32, no
    TF32) and on the host: grid and logits within tolerance, labels agreeing
    on >= 99% of pixels (a landing pixel moves when a grid coordinate
    straddles an integer)."""
    import torch

    host, card = _tiny_pair(device)
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


def check_small_scoremap_against_host(device) -> dict:
    """The score map and round trips of the tiny encoder, card (f32, no TF32)
    against host: the score map within 1e-4 relative on the pixels whose
    task index agrees (>= 99% of them: a landing pixel moves when a grid
    coordinate straddles an integer), the round-trip labels on >= 99% of
    pixels, and the image round trip within 1e-4 on the pixels whose filled
    seed agrees."""
    import torch

    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid
    from fovealseg_torch.ops.jfa import nearest_payload_packed_plain, nearest_seed_plain

    host, card = _tiny_pair(device)
    x, f = frames(2, 64, SEED + 9, "cpu")
    y = labels(2, 64, SEED + 10, "cpu")
    kw = dict(y_sampled_reverse=True, x_sampled_reverse=True)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.infer(x.to(device), f.to(device), y=y.to(device), **kw)
    ref = host.infer(x, f, y=y, **kw)
    got = {k: v.cpu() for k, v in got.items()}

    def winners(out):
        task_idx, valid = inverse_grid_index(out["grid"], (64, 64))
        rounds = jfa_rounds_from_grid(out["grid"], (64, 64))
        return nearest_payload_packed_plain(valid, task_idx, 8, rounds), nearest_seed_plain(valid)

    (t_card, s_card), (t_host, s_host) = winners(got), winners(ref)
    same_t, same_s = t_card == t_host, s_card == s_host
    scale = ref["pred_sampled"].abs().max()
    serr = ((got["pred_sampled"] - ref["pred_sampled"]).abs()[same_t].max() / scale).item()
    xerr = (got["x_sampled_reverse"] - ref["x_sampled_reverse"]).abs()[same_s].max().item()
    yagree = (got["y_sampled_reverse"] == ref["y_sampled_reverse"]).float().mean().item()
    res = {"small_scoremap_task_index_agreement": same_t.float().mean().item(),
           "small_scoremap_rel_err": serr, "small_x_reverse_abs_err": xerr,
           "small_y_reverse_agreement": yagree}
    log(f"small input score map card vs host: {json.dumps(res)}")
    if (res["small_scoremap_task_index_agreement"] < 0.99 or serr > 1e-4 or xerr > 1e-4
            or yagree < 0.99 or same_s.float().mean().item() < 0.99):
        raise AssertionError("card and host disagree on the small input's score map")
    return res


if __name__ == "__main__":
    sys.exit(main())
