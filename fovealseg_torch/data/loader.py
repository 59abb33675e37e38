"""Host input pipeline (counterpart of ``fovealseg_tpu/data/loader.py``):
the dataset interface, a whole-dataset RAM cache, and background prefetch.

``prefetch``: a thread runs the batch iterable ``size`` items ahead of the consumer, so
host batch preparation overlaps the card's steps. When the consumer stops
early (a ``break``, an exception, the generator closed), the worker is told
to stop and exits instead of blocking on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class AbstractDataset:
    """The dataset interface: ``len`` and indexing."""

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - interface
        raise NotImplementedError


class CachedDataset(AbstractDataset):
    """Keeps every item of ``base`` in RAM after its first read."""

    def __init__(self, base):
        self.base = base
        self._cache: dict = {}

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        if idx not in self._cache:
            self._cache[idx] = self.base[idx]
        return self._cache[idx]


def check_class_ids(class_ids, num_class: int, where: str) -> None:
    """Raise unless every training id lies in ``[0, num_class - 1)``: the
    train and eval steps label an object pixel with its id and the rest with
    ``num_class - 1``, the background."""
    bad = sorted({int(c) for c in class_ids if not 0 <= int(c) < num_class - 1})
    if bad:
        raise ValueError(
            f"{where}: training ids {bad} do not fit DATASET.num_class={num_class} (object ids "
            f"must lie in [0, {num_class - 1}); {num_class - 1} is the background); cook only "
            f"the classes the config trains, or raise DATASET.num_class")


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
