"""N rank processes on one machine (counterpart of
``fovealseg_tpu/parallel/multiprocess_demo.py::run_workers``, and of the
reference's ``mp.spawn(main, nprocs=#GPUs)``).

``run_workers(n, target, *args)`` starts ``n`` OS processes; rank ``r`` joins
the process group through a file store in a fresh temporary directory (no
port is fixed, so launches side by side do not meet), calls
``target(Rank(...), *args)`` and hands its return value back (tensors moved
to the host). The parent drains every worker's output while they run (a
worker that prints more than a pipe holds does not block), stops the other
workers as soon as one fails and raises with the last lines of each rank
seen failed, and enforces a deadline.

Devices: ``device="cuda"`` puts rank r on ``cuda:r`` and raises when more
ranks are asked for than cards are visible (a silent truncation would
misattribute throughput); ``device="cpu"`` runs every rank on the host; a
list names each rank's device. The backend follows the device (NCCL on
cards, gloo on the CPU); gloo may be asked for on cards, and only gloo lets
two ranks share a card. Nothing falls back.

``target`` is a function or a ``"module:name"`` string; a function of a
script run as ``__main__`` is found again through the script's path. The
workers inherit this process's import path.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Sequence, Union

import torch

from fovealseg_torch.parallel.multihost import backend_for, initialize

TAIL_LINES = 200


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a worker is told about itself."""

    rank: int
    world_size: int
    backend: str
    device: torch.device


class WorkerError(RuntimeError):
    """A rank process failed or missed the deadline."""


def rank_devices(n: int, device: Union[str, torch.device, Sequence] = "cuda",
                 backend: str | None = None) -> tuple[list[torch.device], str]:
    """Each rank's device and the backend, checked: every named card must be
    visible, NCCL needs cards and one card per rank."""
    if n < 1:
        raise ValueError(f"{n} ranks")
    if isinstance(device, (str, torch.device)):
        d = torch.device(device)
        if d.type == "cpu":
            devices = [d] * n
        elif d.index is None:
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [d]
    else:
        devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
                   for d in device]
    if len(devices) != n:
        raise ValueError(f"{n} ranks but {len(devices)} devices named: {devices}")
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"ranks on CPU and CUDA devices at once: {devices}")
    cuda = devices[0].type == "cuda"
    if cuda:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if max(d.index for d in devices) >= visible:
            raise ValueError(
                f"{n} rank(s) on {[str(d) for d in devices]} but only {visible} card(s) are "
                "visible: a silent truncation would misattribute throughput")
    backend = backend or backend_for(devices[0])
    if backend == "nccl" and not cuda:
        raise ValueError("NCCL needs CUDA devices; the CPU ranks use gloo")
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError(f"NCCL puts one rank on each card, and {devices} repeats one")
    return devices, backend


def _target_spec(target: Union[str, Callable]) -> str:
    if isinstance(target, str):
        return target
    module = target.__module__
    if module == "__main__":
        module = os.path.abspath(sys.modules["__main__"].__file__)
    return f"{module}:{target.__qualname__}"


def _resolve(spec: str) -> Callable:
    module, name = spec.rsplit(":", 1)
    if module.endswith(".py"):
        loader = importlib.util.spec_from_file_location("__rank_main__", module)
        mod = importlib.util.module_from_spec(loader)
        sys.modules["__rank_main__"] = mod
        loader.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _drain(pipe, tail: collections.deque, prefix: str, echo: bool) -> None:
    for line in iter(pipe.readline, ""):
        tail.append(line)
        if echo:
            sys.stdout.write(prefix + line)
            sys.stdout.flush()
    pipe.close()


def run_workers(n: int, target: Union[str, Callable], *args, device="cuda",
                backend: str | None = None, timeout: float = 900.0, threads: int | None = None,
                echo: bool = False) -> list:
    """Run ``target(Rank, *args)`` in ``n`` rank processes and return their
    results in rank order. ``threads`` sets each worker's torch threads;
    ``echo`` copies the workers' output lines to this process's stdout,
    each prefixed with its rank. Raises :class:`WorkerError` when a worker
    fails or the deadline (``timeout`` seconds) passes, after stopping every
    worker."""
    devices, backend = rank_devices(n, device, backend)
    spec = _target_spec(target)
    work = tempfile.mkdtemp(prefix="fovealseg_ranks_")
    torch.save(args, os.path.join(work, "args.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(os.path.abspath(p or os.curdir) for p in sys.path
                                        if os.path.isdir(p or os.curdir))
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    procs, tails, readers = [], [], []
    failed = []
    try:
        for r, d in enumerate(devices):
            cmd = [sys.executable, "-m", "fovealseg_torch.parallel.launch", "--target", spec,
                   "--rank", str(r), "--world-size", str(n), "--backend", backend,
                   "--device", str(d), "--dir", work, "--threads", str(threads or 0)]
            rank_env = {**env, "RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": str(r)}
            p = subprocess.Popen(cmd, env=rank_env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True, errors="replace")
            tail = collections.deque(maxlen=TAIL_LINES)
            t = threading.Thread(target=_drain, args=(p.stdout, tail, f"[rank {r}] ", echo),
                                 daemon=True)
            t.start()
            procs.append(p)
            tails.append(tail)
            readers.append(t)
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            # every rank seen failed in this poll: a rank's failure often makes
            # the ranks waiting on it fail too, in the same instant
            failed = [(r, f"failed (rc={c})") for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [(r, f"missed the {timeout:.0f} s deadline")
                          for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in readers:
            t.join(timeout=10)
    try:
        if failed:
            raise WorkerError("\n".join(
                f"rank {r} of {n} ({devices[r]}, {backend}) {what}; its last lines:\n"
                f"{''.join(tails[r])}" for r, what in failed))
        return [torch.load(os.path.join(work, f"result.{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _worker_main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one rank of run_workers")
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--threads", type=int, default=0)
    a = p.parse_args(argv)
    try:
        if a.threads:
            torch.set_num_threads(a.threads)
        fn = _resolve(a.target)
        args = torch.load(os.path.join(a.dir, "args.pt"), weights_only=False)
        device = torch.device(a.device)
        initialize(f"file://{os.path.join(a.dir, 'store')}", a.world_size, a.rank, a.backend,
                   device)
        result = fn(Rank(a.rank, a.world_size, a.backend, device), *args)
        out = os.path.join(a.dir, f"result.{a.rank}.pt")
        torch.save(_to_host(result), out + ".tmp")
        os.replace(out + ".tmp", out)
        torch.distributed.destroy_process_group()
    except BaseException:
        # no interpreter shutdown with a live process group: the parent stops
        # the other ranks, which may be waiting in a collective
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()


if __name__ == "__main__":
    _worker_main()
