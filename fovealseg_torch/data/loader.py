"""Background prefetch (counterpart of ``fovealseg_tpu/data/loader.py::prefetch``).

A thread runs the batch iterable ``size`` items ahead of the consumer, so
host batch preparation overlaps the card's steps. When the consumer stops
early (a ``break``, an exception, the generator closed), the worker is told
to stop and exits instead of blocking on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


def prefetch(iterable: Iterable, size: int = 2, transform: Callable | None = None) -> Iterator:
    """Yield the items of ``iterable`` (through ``transform``) made in a
    background thread, at most ``size`` of them waiting. A worker's
    exception is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer has gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(transform(item) if transform else item):
                    return
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
