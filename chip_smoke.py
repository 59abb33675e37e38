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
        one more epoch resumed from ``epoch_last``) and the eval CLI on its
        epoch-3 checkpoint;
  4. summary: the card line, one JSON line of per-kernel numbers, and the
     last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

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
    reports = build.build(["jfa", "gather"])
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, rep in reports.items():
        for line in rep.strip().splitlines():
            log(f"  ptxas[{name}]: {line}")
    return card


def flagship(dtype, device, **overrides):
    import torch

    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(80, 80), task_hw_infer=(80, 80), saliency_hw=(80, 80),
                       gaussian_radius=45, num_class=51, arch_encoder="hrnetv2_nodownsp",
                       **overrides)
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


def hold(name, label, kernel, plain, bound_ms, libraries=None, n=20):
    """Run ``kernel`` and ``plain`` once, require bit-equal outputs, then
    time both: the kernel in CUDA events around one call on an idle stream
    (``ms``), over back-to-back calls (``loop_ms``) and as the sum of its
    kernels' device times under torch.profiler (``device_ms``); each of
    ``libraries`` ({name: fn}, the first one is ``library``) in events and
    device time. Returns the numbers."""
    import torch

    from fovealseg_torch.tools.profile_gather import device_ms, events_ms, loop_ms

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
    dev_ms = device_ms(kernel, n)[0]
    lp_ms = loop_ms(kernel, n)
    plain_ms = events_ms(plain, n, warmup=1)
    libs = {lib: {"ms": events_ms(fn, n), "device_ms": device_ms(fn, n)[0]}
            for lib, fn in (libraries or {}).items()}
    library_ms = next(iter(libs.values()))["ms"] if libs else None
    log(f"{name} [{label}]: bit-equal; kernel {ms:.4f} ms events, {lp_ms:.4f} ms back to back, "
        f"{dev_ms:.4f} ms device; plain {plain_ms:.4f} ms; "
        + "".join(f"{lib} {v['ms']:.4f} ms events, {v['device_ms']:.4f} ms device; "
                  for lib, v in libs.items())
        + f"bound {bound_ms:.4f} ms (bytes)")
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


def time_infer(model, device, **kw):
    """b8 fps and b1 latency of ``infer(**kw)``, CUDA-event timed, and b1 on
    the host clock. Returns the numbers and the count of calls made."""
    import torch

    from fovealseg_torch.tools.profile_gather import events_ms

    x8, f8 = frames(8, CANVAS, SEED + 1, device)
    x1, f1 = frames(1, CANVAS, SEED + 2, device)
    b8_ms = events_ms(lambda: model.infer(x8, f8, **kw), 10, warmup=2)
    b1_ms = events_ms(lambda: model.infer(x1, f1, **kw), 20, warmup=2)
    host = []
    for _ in range(10):
        t = time.perf_counter()
        model.infer(x1, f1, **kw)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    return dict(b8_ms=b8_ms, b8_fps=8 / (b8_ms / 1e3), b1_ms=b1_ms,
                b1_host_ms=statistics.median(host)), 2 + 10 + 2 + 20 + 10


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


def _host_and_card_step(device, opts):
    """One train step of the tiny pair (same weights, dropout off) on the
    card and on the host on one synthetic b2 batch: (host, card) as
    (model, mets, grads, params before) each."""
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
    for model in (host, card):
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


def check_small_train_against_host(device) -> dict:
    """One train step of the tiny pair, card (f32, TF32 off) against host,
    dropout off on both: the loss within 1e-4; each group's gradient within
    5% in norm (on the host alone, moving the warped image by 1.4e-5 of its
    scale moves the tiny encoder's train-mode gradients by 2.3%: its
    smallest BN branch normalises 8 values); BN statistics within 1e-3 of
    their update in norm; every updated parameter within 2.01 learning rates
    of the host's (Adam's first step moves every element by ~lr whatever its
    gradient's size, so an element whose gradient is at the noise level
    moves +lr on one device and -lr on the other; the update's norm says
    nothing and is only printed: 25 compress weights read 0.1% and 19% in
    two runs). Then one ``MODEL.loss_at_high_res`` step in
    'nearest' and in 'BI': the saliency nets' gradient (it reaches them only
    through the row gather's backward) must be non-zero and within 5% of
    the host's, and K5b must have run."""
    import torch

    from fovealseg_torch.ops import gather
    from fovealseg_torch.train.optim import GROUPS

    prev = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        (h_model, h_mets, h_grads, h_before), (c_model, c_mets, c_grads, c_before) = \
            _host_and_card_step(device, [])
        res = {"loss_host": h_mets["loss"], "loss_card": c_mets["loss"],
               "loss_rel_err": abs(c_mets["loss"] - h_mets["loss"]) / abs(h_mets["loss"])}
        res["grad_rel_err"] = {g: _rel(c_grads[g], h_grads[g]) for g in h_grads}
        h_sd, c_sd = h_model.state_dict(), c_model.state_dict()
        stat_num = stat_den = 0.0
        upd_err, max_dev = {}, 0.0
        for name, sub, _, mult in GROUPS:
            num = den = 0.0
            for k in h_sd:
                if not k.startswith(sub + ".") or "num_batches" in k:
                    continue
                dh = (h_sd[k] - h_before[k]).double()
                dc = (c_sd[k].cpu() - c_before[k].cpu()).double()
                if "running_" in k:
                    stat_num += float(((dc - dh) ** 2).sum())
                    stat_den += float((dh ** 2).sum())
                else:
                    num += float(((dc - dh) ** 2).sum())
                    den += float((dh ** 2).sum())
                    max_dev = max(max_dev, float((dc - dh).abs().max()))
            upd_err[name] = (num / max(den, 1e-300)) ** 0.5
        res["update_rel_err"] = upd_err
        res["bn_stat_rel_err"] = (stat_num / max(stat_den, 1e-300)) ** 0.5
        lr = 0.1 * train_cfg(*TINY_OPTS).TRAIN.lr_mult_encoder
        res["max_param_dev_over_lr"] = max_dev / lr
        log(f"tiny train step card vs host: {json.dumps(res)}")
        if (res["loss_rel_err"] > 1e-4 or max(res["grad_rel_err"].values()) > 0.05
                or res["bn_stat_rel_err"] > 1e-3 or res["max_param_dev_over_lr"] > 2.01):
            raise AssertionError("the tiny train step on the card disagrees with the host's")
        for interp in ("nearest", "BI"):
            before = gather.row_gather_backward.launches
            (_, h_mets, h_grads, _), (_, c_mets, c_grads, _) = _host_and_card_step(
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
            "rev_deform_interp": cfg.MODEL.rev_deform_interp}
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


def time_train(card, device, dtype) -> dict:
    """The flagship's default training step at b8: 2 warm-up steps, 10 timed
    (host clock, ending in a synchronise), then 2 under torch.profiler for
    the device-busy time and the kernels per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fovealseg_torch.train.loop import batch_controls

    cfg = train_cfg()
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
    for i in range(10):
        run(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            run(i)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / 2
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"training {dtype}: non-finite loss {losses}")
    top = {}
    for e in kernels:
        top[e.name[:50]] = top.get(e.name[:50], 0.0) + e.time_range.elapsed_us() / 2e3
    res = dict(samples_per_s=8 / (step_ms / 1e3), step_ms=step_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / step_ms, kernels_per_step=len(kernels) / 2,
               losses=losses, top_kernels_ms=dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"train b8 {dtype}: {res['samples_per_s']:.2f} samples/s ({step_ms:.2f} ms/step host "
        f"clock), device busy {busy_ms:.2f} ms/step, idle share {res['idle_share']:.3f}, "
        f"{res['kernels_per_step']:.0f} kernels/step; losses {losses} on {card}")
    log(f"train b8 {dtype} top kernels (ms/step): {json.dumps(res['top_kernels_ms'])}")
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
    seconds = time.perf_counter() - t
    log(f"phase 3d took {seconds:.1f} s on {card}")
    return numbers, counts, dict(small_train=small, train=timing, train_high_res=high_res,
                                 train_cli=cli_res, phase_3d_s=seconds)


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
                   "train": train_counts[name]}
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
    log(json.dumps({"serving": serving, "scoremap": scoremap, "eval": evaluation, **training,
                    "small_input_label_agreement": small_label_agreement, **checks}))
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
