"""Does torch.profiler keep every kernel record over many sessions?

In one process, alternates a large profiled session (``--burst`` kernels per
call, 10 calls) with four small ones (1 kernel per call, 10 calls) and
prints a JSON line every 10 rounds and at every round where a session held
fewer kernel records than it launched kernels; at the end, the first such
round (sessions and records so far, seconds). ``chip_smoke.py`` reads its
device times through the same profiler and re-reads a run that saw no
kernel (``profiled_ms``).

Usage (on a machine with a CUDA card):
  python -m fovealseg_torch.tools.profiler_records [--seconds 360] [--burst 2000]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def kernel_records(fn, n: int = 10) -> int:
    """The kernel records of ``n`` calls of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=360.0)
    ap.add_argument("--burst", type=int, default=2000)
    args = ap.parse_args(argv)
    x = torch.randn(1 << 16, device="cuda")

    def burst(k):
        for _ in range(k):
            x.add_(1)

    t0 = time.perf_counter()
    sessions = records = 0
    first_loss = None
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        big = kernel_records(lambda: burst(args.burst))
        small = [kernel_records(lambda: burst(1)) for _ in range(4)]
        sessions += 5
        records += big + sum(small)
        lost = big != 10 * args.burst or any(s != 10 for s in small)
        if lost and first_loss is None:
            first_loss = {"round": i, "sessions": sessions, "records": records,
                          "seconds": time.perf_counter() - t0}
        if i % 10 == 0 or lost:
            print(json.dumps({"round": i, "sessions": sessions, "records": records, "big": big,
                              "small": small, "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        i += 1
    print(json.dumps({"rounds": i, "sessions": sessions, "records": records,
                      "first_loss": first_loss}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
