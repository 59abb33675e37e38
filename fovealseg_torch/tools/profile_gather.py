"""The row gather (K5) beside ``index_select``, and its backward (K5b)
beside ``index_add_`` and ``index_put_``, three ways of timing each.

Builds the flagship (HRNetV2-nodownsp + C1, 640x640 canvas -> 80x80 task, 51
classes, random weights from a seed), serves one b8 batch, and gathers at
the inverse warp's own indices: the payload flood's (K2) task index and the
seed flood's (K4) canvas index. K5 cases, at the main path's shapes:

* C = 51: the score map [8, 6400, 51] at K2's output;
* C = 1: int32 labels [8, 6400, 1] at K2's output (the label round trip);
* C = 2: the filled inverse grid [8, 409600, 2] at K4's output;
* C = 3: an image [8, 409600, 3] at K4's output (the far fill of 'BI').

For K5 and for ``index_select`` over the flattened table, given the ready
int64 flat indices and given the int32 index map (one add of a precomputed
int32 batch offset, then ``index_select`` on the int32 result), each case
prints:

* ``events_ms``: CUDA events around one call on an idle stream, median of
  ``--n`` (the host's lead-in before the first launch counts);
* ``loop_ms``: CUDA events around ``--n`` back-to-back calls, over ``--n``
  (the host's launch time hides behind the card's work when it is shorter);
* ``device_ms``: the call's kernel times summed under ``torch.profiler``
  (over ``--n`` calls), with ``kernels_per_call``.

K5b cases (:func:`k5b_cases`), random f32 gradient rows at the same indices:
'nearest' [8, 409600, 51] into [8, 6400, 51] at K2's output and 'BI' [8,
409600, 51] into [8, 409600, 51] at K4's output (the two shapes that
``MODEL.loss_at_high_res`` trains with), C = 1 at K2's output, C = 2 and
3 at K4's (no path launches K5b at these widths), and the gradient and
indices that K5b receives in one such training step of the flagship, in
'nearest' and 'BI' (:func:`train_step_cases`), with the pixels per table
row of each. Each is timed the same three ways beside ``index_add_`` into
a zeroed table (atomic) and ``index_put_(accumulate=True)`` under
``torch.use_deterministic_algorithms`` (whose bits are checked for
repeating), with the byte bound (``grad_out`` and the indices read once,
the table written once, at 3.35 TB/s).
``--atomic-k5b SRC`` also times the atomic K5b of an earlier tree: its
``csrc/gather.cu``, whose ``fovealseg_row_gather_backward`` adds into a
table the caller zeroed, built here with the same flags; the two K5b run in
turns (earlier, this, this, earlier) in one process.

It checks K5 and K5b bit-equal to their plain versions on every case, K5b
also over two launches, and prints the card's name and power limit. Usage,
on a machine with the card:

    python -m fovealseg_torch.tools.profile_gather [--n 50]
        [--atomic-k5b path/to/earlier/csrc/gather.cu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def events_ms(fn, n: int, warmup: int = 3) -> float:
    """Median ms of one call between two CUDA events on an idle stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, n: int) -> float:
    """Mean ms per call over ``n`` back-to-back calls between two events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int) -> tuple[float, float, dict[str, float]]:
    """(device ms per call, kernels per call, {kernel name: device ms per
    call}) of ``fn`` under torch.profiler: the sum of the times of the
    kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names: dict[str, float] = {}
    for e in kernels:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")[:60]
        names[name] = names.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n, len(kernels) / n, names)


def timed(fn, n: int) -> dict:
    dev, per_call, names = device_ms(fn, n)
    return {"events_ms": events_ms(fn, n), "loop_ms": loop_ms(fn, n), "device_ms": dev,
            "kernels_per_call": per_call, "kernels": names}


def flagship_cases(device, seed: int = 309):
    """[(label, table, idx)] at the flagship's inverse-warp indices."""
    from fovealseg_torch.core.grid import grid_from_index, inverse_grid_index
    from fovealseg_torch.core.unwarp import halfpixel_avg, jfa_rounds_from_grid
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.ops import jfa

    model = init_weights(DeformSegmentation(DeformConfig(), device=device),
                         torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 640, 640, 3)).astype(np.float32)).to(device)
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (8, 2)).astype(np.float32)).to(device)
    out = model.infer(x, f, argmax_labels=True)
    task_idx, valid = inverse_grid_index(out["grid"], (640, 640))
    rounds = jfa_rounds_from_grid(out["grid"], (640, 640))
    b, h, w = valid.shape
    th, tw = out["pred"].shape[1:3]
    tidx = jfa.nearest_payload_packed(valid, task_idx, (th * tw - 1).bit_length(), rounds)
    tidx = tidx.reshape(b, h * w)
    seeds = jfa.nearest_seed(valid, None).reshape(b, h * w)
    scores = halfpixel_avg(out["pred"].float()).reshape(b, th * tw, -1).contiguous()
    grid_inv = grid_from_index(task_idx, valid, (th, tw))
    grid_inv = torch.where(torch.isnan(grid_inv), 0.0, grid_inv).reshape(b, h * w, 2)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    labels = torch.randint(0, 51, (b, th * tw, 1), generator=g, dtype=torch.int32).to(device)
    image = x.reshape(b, h * w, 3) * valid.reshape(b, h * w, 1)
    del model, out
    return [(f"C=51 score map {list(scores.shape)} at K2's output", scores, tidx),
            (f"C=1 labels int32 {list(labels.shape)} at K2's output", labels, tidx),
            (f"C=2 filled grid {list(grid_inv.shape)} at K4's output", grid_inv.contiguous(), seeds),
            (f"C=3 image {list(image.shape)} at K4's output", image.contiguous(), seeds)]


def measure_case(table: torch.Tensor, idx: torch.Tensor, n: int) -> dict:
    """K5 and index_select on one (table, idx), bit-equality checked."""
    from fovealseg_torch.ops.gather import row_gather, row_gather_plain

    b, t, c = table.shape
    out = row_gather(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), row_gather_plain(table, idx).view(torch.int32)):
        raise AssertionError("row_gather != row_gather_plain")
    del out
    flat = table.reshape(b * t, c)
    off64 = torch.arange(b, device=table.device, dtype=torch.int64).view(b, 1) * t
    flat64 = (idx.reshape(b, -1).long().clamp(0, t - 1) + off64).reshape(-1)
    off32 = torch.arange(b, device=table.device, dtype=torch.int32).view(b, 1) * t
    bytes_ = idx.numel() * (c + 1) * 4 + table.numel() * 4
    return {
        "shape": list(table.shape), "idx_shape": list(idx.shape), "bytes": bytes_,
        "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
        "k5": timed(lambda: row_gather(table, idx), n),
        "index_select_int64": timed(lambda: torch.index_select(flat, 0, flat64), n),
        "index_select_int32": timed(
            lambda: torch.index_select(flat, 0, (idx.reshape(b, -1) + off32).view(-1)), n),
    }


def k5b_cases(device, seed: int = 309):
    """[(label, grad_out [B, N, C], idx [B, N] int32, T)] for K5b at the
    flagship's inverse-warp indices (:func:`flagship_cases`), gradients from
    a generator seeded with ``seed + 2``."""
    cases = flagship_cases(device, seed)
    tidx, seeds = cases[0][2], cases[2][2]
    b, n = tidx.shape
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    out = []
    for label, idx, t, c in (("'nearest' C=51 [8, 409600, 51] into [8, 6400, 51] at K2's output",
                              tidx, 6400, 51),
                             ("'BI' C=51 [8, 409600, 51] into [8, 409600, 51] at K4's output",
                              seeds, n, 51),
                             ("C=1 into [8, 6400, 1] at K2's output (no path)", tidx, 6400, 1),
                             ("C=2 into [8, 409600, 2] at K4's output (no path)", seeds, n, 2),
                             ("C=3 into [8, 409600, 3] at K4's output (no path)", seeds, n, 3)):
        out.append((label, torch.randn((b, n, c), generator=gen, device=device), idx, t))
    return out


def train_step_cases(device, seed: int = 304):
    """[(label, grad_out, idx, T)] that K5b receives in one b8 training step
    of the flagship with ``MODEL.loss_at_high_res``, in 'nearest' and in
    'BI' (``deform.yaml`` with the flagship's sizes, random weights and a
    synthetic batch from ``seed``): the gradient and index map that
    ``RowGather.backward`` receives in the step, copied on the way."""
    from pathlib import Path

    from fovealseg_torch import configs
    from fovealseg_torch.data.synthetic import make_batch_device
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.ops import gather
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.loop import batch_controls
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    out = []
    backward = gather.RowGather.backward

    def copy_inputs(ctx, grad_out):
        out.append((grad_out.detach().contiguous().clone(), ctx.saved_tensors[0].clone(),
                    ctx.rows))
        return backward(ctx, grad_out)

    for interp in ("nearest", "BI"):
        cfg = configs.get_default_cfg()
        cfg.merge_from_file(str(Path(configs.__file__).parent / "deform.yaml"))
        cfg.merge_from_list(["TRAIN.task_input_size", "(80,80)", "TRAIN.saliency_input_size",
                             "(80,80)", "MODEL.gaussian_radius", "45", "DATASET.num_class", "51",
                             "TRAIN.batch_size_per_gpu", "8", "MODEL.loss_at_high_res", "True",
                             "MODEL.rev_deform_interp", interp])
        model = DeformSegmentation(DeformConfig(
            task_hw=(80, 80), task_hw_infer=(80, 80), saliency_hw=(80, 80), gaussian_radius=45,
            num_class=51, arch_encoder="hrnetv2_nodownsp", loss_at_high_res=True,
            rev_deform_interp=interp), device=device)
        init_weights(model, torch.Generator().manual_seed(seed))
        state = S.init_state(model, create_optimizer(cfg, model), seed)
        step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = make_batch_device(gen, 8, 640, 50)
        gather.RowGather.backward = staticmethod(copy_inputs)
        try:
            step(state, {**batch, **batch_controls(cfg, 1, state.step, state.pool_rng)})
        finally:
            gather.RowGather.backward = staticmethod(backward)
        g, idx, t = out.pop()
        b, c = g.shape[0], g.shape[-1]
        out.append((f"train step '{interp}' C={c} [{b}, {idx[0].numel()}, {c}] into "
                    f"[{b}, {t}, {c}]", g.reshape(b, -1, c), idx.reshape(b, -1), t))
        del model, state, step, batch
    torch.cuda.empty_cache()
    return out


def row_lengths(idx: torch.Tensor, t: int) -> dict:
    """The pixels per non-empty table row of an index map [B, N]."""
    b = idx.shape[0]
    off = torch.arange(b, device=idx.device).view(b, 1) * t
    counts = torch.bincount((idx.long().clamp(0, t - 1) + off).view(-1), minlength=b * t)
    used = counts[counts > 0].float()
    q = torch.quantile(used, torch.tensor([0.5, 0.99, 0.999], device=idx.device)).tolist()
    return {"rows": used.numel(), "mean": used.mean().item(), "p50": q[0], "p99": q[1],
            "p999": q[2], "max": int(used.max().item()),
            "rows_over_256": int((used > 256).sum().item())}


def k5b_bound_ms(grad_out: torch.Tensor, t: int) -> float:
    """Bytes over 3.35 TB/s: grad_out and the indices read once, the [B, T,
    C] table written once."""
    b, n, c = grad_out.shape
    return (b * n * c * 4 + b * n * 4 + b * t * c * 4) / HBM_BYTES_PER_S * 1e3


def k5b_libraries(grad_out: torch.Tensor, idx: torch.Tensor, t: int) -> dict:
    """{name: fn} of the PyTorch calls that compute K5b's function: the
    atomic ``index_add_`` (int32 flat indices) into a zeroed table, and
    ``index_put_(accumulate=True)`` (int64 flat indices) under
    ``torch.use_deterministic_algorithms(True)``."""
    b, n, c = grad_out.shape
    dev = grad_out.device
    off32 = torch.arange(b, device=dev, dtype=torch.int32).view(b, 1) * t
    flat32 = (idx.clamp(0, t - 1) + off32).view(-1)
    flat64 = flat32.long()
    g2 = grad_out.view(-1, c)

    def index_add():
        return torch.zeros((b * t, c), device=dev).index_add_(0, flat32, g2)

    def index_put():
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return torch.zeros((b * t, c), device=dev).index_put_((flat64,), g2, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(prev)

    return {"index_add_": index_add, "index_put_deterministic": index_put}


def atomic_k5b(source: str):
    """``fn(grad_out, idx, t)``: the atomic K5b of an earlier tree's
    ``csrc/gather.cu`` (its backward entry adds into a table the caller
    zeroed), compiled with this tree's nvcc flags into ``build/kernels``."""
    import ctypes
    import hashlib
    import os

    from fovealseg_torch.ops import build

    src = open(source, "rb").read()
    lib = build.BUILD_DIR / f"libatomic_k5b-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp), source], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).fovealseg_row_gather_backward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(grad_out, idx, t):
        b, n, c = grad_out.shape
        grad = torch.zeros((b, t, c), device=grad_out.device)
        err = fn(grad_out.data_ptr(), idx.data_ptr(), grad.data_ptr(), b, n, t, c,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"atomic K5b launch failed with CUDA error {err}")
        return grad

    return run


def measure_k5b(grad_out: torch.Tensor, idx: torch.Tensor, t: int, n: int, atomic=None) -> dict:
    """K5b against its plain version (bit-equal, and over two launches),
    then K5b, the library calls and (if given) the atomic K5b timed."""
    from fovealseg_torch.ops.gather import row_gather_backward, row_gather_backward_plain

    first = row_gather_backward(grad_out, idx, t)
    second = row_gather_backward(grad_out, idx, t)
    ref = row_gather_backward_plain(grad_out, idx, t)
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("row_gather_backward != row_gather_backward_plain")
    if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
        raise AssertionError("row_gather_backward: two launches differ")
    del second, ref
    libs = k5b_libraries(grad_out, idx, t)
    det = [libs["index_put_deterministic"]() for _ in range(2)]
    res = {"shape": list(grad_out.shape), "rows": t, "bound_ms": k5b_bound_ms(grad_out, t),
           "row_lengths": row_lengths(idx, t),
           "index_put_deterministic_repeats": torch.equal(det[0].view(torch.int32),
                                                          det[1].view(torch.int32)),
           "index_put_deterministic_equals_k5b": torch.equal(
               det[0].view(torch.int32), first.reshape(det[0].shape).view(torch.int32))}
    del det, first
    k5b = lambda: row_gather_backward(grad_out, idx, t)  # noqa: E731
    if atomic is None:
        res["k5b"] = timed(k5b, n)
    else:
        old = lambda: atomic(grad_out, idx, t)  # noqa: E731
        res["atomic_k5b"] = timed(old, n)
        res["k5b"] = timed(k5b, n)
        res["k5b_again"] = timed(k5b, n)
        res["atomic_k5b_again"] = timed(old, n)
    for name, fn in libs.items():
        res[name] = timed(fn, n)
    return res


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50, help="calls per timing")
    ap.add_argument("--atomic-k5b", metavar="SRC",
                    help="an earlier tree's csrc/gather.cu whose atomic K5b to time beside K5b")
    args = ap.parse_args(argv)

    from fovealseg_torch import resolve_device

    device = resolve_device("cuda")
    print("card:", card_line(), flush=True)
    for label, table, idx in flagship_cases(device):
        res = measure_case(table, idx, args.n)
        print(json.dumps({"case": label, **res}), flush=True)
        del table, idx
    atomic = atomic_k5b(args.atomic_k5b) if args.atomic_k5b else None
    for label, grad_out, idx, t in k5b_cases(device) + train_step_cases(device):
        res = measure_k5b(grad_out, idx, t, args.n, atomic)
        print(json.dumps({"case": label, **res}), flush=True)
        del grad_out, idx
        torch.cuda.empty_cache()
    print("card:", card_line(), flush=True)


if __name__ == "__main__":
    main()
