"""The row gather (K5) beside ``index_select``, three ways of timing each.

Builds the flagship (HRNetV2-nodownsp + C1, 640x640 canvas -> 80x80 task, 51
classes, random weights from a seed), serves one b8 batch, and gathers at
the inverse warp's own indices: the payload flood's (K2) task index and the
seed flood's (K4) canvas index. Cases, at the main path's shapes:

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

It also checks K5 bit-equal to ``row_gather_plain`` on every case and
prints the card's name and power limit. Usage, on a machine with the card:

    python -m fovealseg_torch.tools.profile_gather [--n 50]
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


def device_ms(fn, n: int) -> tuple[float, float, list[str]]:
    """(device ms per call, kernels per call, kernel names) of ``fn`` under
    torch.profiler: the sum of the times of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = sorted({e.name[:60] for e in kernels})
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


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50, help="calls per timing")
    args = ap.parse_args(argv)

    from fovealseg_torch import resolve_device

    device = resolve_device("cuda")
    print("card:", card_line(), flush=True)
    for label, table, idx in flagship_cases(device):
        res = measure_case(table, idx, args.n)
        print(json.dumps({"case": label, **res}), flush=True)


if __name__ == "__main__":
    main()
