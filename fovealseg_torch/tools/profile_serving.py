"""Where the serving time goes on the card.

Runs the flagship's ``infer(argmax_labels=True)`` (HRNetV2-nodownsp + C1,
640x640 canvas -> 80x80 task, 51 classes, random weights from a seed), or
with ``--scores`` its full-res score map ``infer(argmax_labels=False)``, at
each batch size and dtype asked for, and prints one JSON line per cell:

* ``wall_ms``: host clock per call, ending in ``torch.cuda.synchronize()``,
  profiler off;
* ``device_busy_ms``: the sum of the call's kernel times on the card, from
  ``torch.profiler`` (one stream, so kernels do not overlap), and
  ``idle_share`` = 1 - busy / wall;
* ``kernels_per_call``, the device ms of the port's own kernels per call
  (``jfa_ms``: the jump floods; ``gather_ms``: the row gather), and the
  kernels that take the most device time.

Usage (on a machine with a CUDA card):
  python -m fovealseg_torch.tools.profile_serving [--scores] [--batch 8 1]
      [--dtype float32 bfloat16] [--calls 5] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch


def flagship(dtype: torch.dtype, device: torch.device, seed: int = 304):
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    model = DeformSegmentation(DeformConfig(), dtype=dtype, device=device)
    return init_weights(model, torch.Generator().manual_seed(seed))


def profile_cell(model, batch: int, calls: int, trace_path: str | None = None,
                 argmax_labels: bool = True) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 640, 640, 3)).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (batch, 2)).astype(np.float32)).to(dev)
    for _ in range(3):
        model.infer(x, f, argmax_labels=argmax_labels)
    torch.cuda.synchronize(dev)
    walls = []
    for _ in range(calls):
        t = time.perf_counter()
        model.infer(x, f, argmax_labels=argmax_labels)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            model.infer(x, f, argmax_labels=argmax_labels)
        torch.cuda.synchronize(dev)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / calls
        by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    wall = float(np.median(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    jfa_ms = sum(v[0] for k, v in by_name.items() if "jfa_" in k)
    gather_ms = sum(v[0] for k, v in by_name.items() if "::gather_" in k)  # K5's variants
    return {
        "path": "argmax" if argmax_labels else "scores",
        "batch": batch, "dtype": str(model.dtype).replace("torch.", ""),
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if busy else None,
        "kernels_per_call": len(kernels) / calls, "jfa_ms": jfa_ms, "gather_ms": gather_ms,
        "top": [{"kernel": k[:90], "ms": v[0], "per_call": v[1] / calls} for k, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scores", action="store_true",
                    help="profile the full-res score map, infer(argmax_labels=False)")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--trace-dir", default=None, help="write one chrome trace per cell here")
    args = ap.parse_args(argv)

    from fovealseg_torch import resolve_device

    device = resolve_device("cuda")
    for name in args.dtype:
        model = flagship(getattr(torch, name), device)
        for batch in args.batch:
            path = "scores" if args.scores else "serving"
            trace = f"{args.trace_dir}/{path}_{name}_b{batch}.json" if args.trace_dir else None
            cell = profile_cell(model, batch, args.calls, trace, argmax_labels=not args.scores)
            cell["device"] = torch.cuda.get_device_name(device)
            print(json.dumps(cell), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
