"""Process-group bootstrap and per-rank data sharding (counterpart of
``fovealseg_tpu/parallel/multihost.py``).

The reference trains with one process per GPU: ``init_process_group("nccl")``
from MASTER_ADDR/PORT and a vendored ``DistributedSampler`` that hands each
rank a contiguous block of an epoch-seeded permutation. The port keeps that
design:

* :func:`initialize` is ``init_process_group`` from the standard env vars
  (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or an explicit
  ``init_method``; it is a no-op at one process. The backend follows the
  device: NCCL on CUDA devices, gloo on the CPU. A failure raises: nothing
  falls back to another backend or to fewer ranks.
* :func:`host_shard_indices` and :class:`DistributedSampler` are the JAX
  package's reference-semantics sampler, copied (plain numpy).
* :func:`split_batch_axis` slices a batch into equal parts;
  :func:`describe_topology` is the rank's snapshot.

The JAX package's ``global_batch_from_host_local`` has no counterpart: with a
process per rank each rank keeps its own block of the batch, and nothing
assembles a global array.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The backend that follows the device: 'nccl' on CUDA, 'gloo' on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> bool:
    """Join the process group of this rank.

    Arguments default from the standard env vars (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``; ``init_method`` 'env://' reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). Without an ``init_method`` at world size 1 this is a
    no-op. ``device`` (default: ``cuda:LOCAL_RANK``) becomes the current
    CUDA device, and NCCL's communicator is made at once (``device_id``), so
    a failed NCCL init raises here. NCCL with a CPU device raises. Returns
    True when a process group is (already) up."""
    if dist.is_initialized():
        return True
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if init_method is None:
        if world_size <= 1:
            return False
        init_method = "env://"
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    backend = backend or backend_for(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, and rank {rank} was given {device}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return True


def rank_and_world(group=None) -> tuple[int, int]:
    """(rank in ``group``, its size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def host_shard_indices(n: int, num_replicas: int, rank: int, epoch: int = 0,
                       shuffle: bool = True, seed: int = 0) -> np.ndarray:
    """This rank's dataset indices, reference-DistributedSampler semantics.

    Deterministic epoch-seeded permutation, wrap-around padding to
    ``ceil(n / num_replicas) * num_replicas``, contiguous per-rank blocks
    (the reference's vendored sampler takes ``indices[rank * num_samples :
    (rank + 1) * num_samples]``; torch's own strided sampler differs). The
    padding is tiled, so n < num_replicas still gives every rank a full
    block."""
    if not 0 <= rank < num_replicas:
        raise ValueError("rank out of range")
    num_samples = int(math.ceil(n / num_replicas))
    total = num_samples * num_replicas
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    reps = -(-total // max(n, 1))
    order = np.tile(order, reps)[:total]
    return order[rank * num_samples : (rank + 1) * num_samples]


class DistributedSampler:
    """Work-alike of the reference's vendored sampler: ``set_epoch`` re-seeds
    the permutation per epoch; iteration yields this rank's indices."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0):
        self.n = int(dataset_len)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(self.n / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        return iter(host_shard_indices(self.n, self.num_replicas, self.rank, epoch=self.epoch,
                                       shuffle=self.shuffle, seed=self.seed).tolist())

    def __len__(self) -> int:
        return self.num_samples


def split_batch_axis(batch: dict, num: int, index: int) -> dict:
    """Part ``index`` of ``num`` equal slices of every entry along axis 0
    (numpy arrays or tensors); an entry that does not divide raises."""
    out = {}
    for k, v in batch.items():
        if v.ndim == 0 or v.shape[0] % num:
            raise ValueError(f"batch axis of {k!r} not divisible by {num}")
        step = v.shape[0] // num
        out[k] = v[index * step : (index + 1) * step]
    return out


def describe_topology(device=None, group=None) -> dict:
    """This rank's snapshot: rank, world size, backend, its device (default:
    the current CUDA device, else the CPU) and that device's name, and the
    cards this process sees."""
    rank, world = rank_and_world(group)
    cuda = torch.cuda.is_available()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if cuda else "cpu"
    device = torch.device(device)
    return {
        "rank": rank,
        "world_size": world,
        "backend": dist.get_backend(group) if dist.is_initialized() else None,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "local_device_count": torch.cuda.device_count() if cuda else 0,
    }
