"""1-D data parallelism (counterpart of the 1-D part of
``fovealseg_tpu/parallel/mesh.py``).

The JAX package wraps its train step in ``shard_map`` over a 1-D 'data'
mesh: the state replicated, the batch split into contiguous blocks
(``P('data')``), gradients and metrics averaged with ``pmean``, dropout
folded with the replica's index, BN synced through its ``axis_name``. The
port runs one process per rank (``parallel/launch.py``) and keeps those
semantics:

* :func:`shard_batch` gives a rank its contiguous block of the global batch
  and leaves the per-step scalars whole;
* :func:`replicate_state` copies rank 0's parameters and BN statistics to
  every rank (:func:`broadcast_tensors`) and folds each rank's dropout
  generator with its rank.

The steps are ``train/step.py``'s, given a process group (the JAX
``make_parallel_train_step`` is ``make_train_step(..., group=...)``): the
forward and the loss run under DDP (the reference's mechanism), which
averages the gradients over the ranks as ``pmean`` does, and the metrics
are averaged after the step; the model in ``TrainState`` stays unwrapped,
so checkpoint keys carry no ``module.`` prefix. The eval step averages its
metrics.

Loss terms that normalise over a batch (the edge loss's min-max, Dice) are
per rank, as in the JAX step and the reference's DDP: each rank normalises
over its own block and only the gradients are averaged.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from fovealseg_torch.parallel.multihost import split_batch_axis

# per-step scalars, not split over the ranks (the JAX package's set)
_REPLICATED_KEYS = {"edge_scale", "edge_only", "pool_s"}


def shard_batch(batch: dict, rank: int, world_size: int) -> dict:
    """Rank ``rank``'s contiguous block of every batch entry (the
    ``P('data')`` layout); 0-d entries and the per-step scalars stay whole."""
    whole = {k for k, v in batch.items() if k in _REPLICATED_KEYS or getattr(v, "ndim", 0) == 0}
    block = split_batch_axis({k: v for k, v in batch.items() if k not in whole}, world_size, rank)
    return {k: batch[k] if k in whole else block[k] for k in batch}


def fold_generator(gen: torch.Generator, rank: int, step: int) -> torch.Generator:
    """The counterpart of ``fold_in(rng, axis_index)``: rank 0 keeps its
    stream (so one rank is the single-process run, bit for bit), rank r > 0
    is reseeded from the stream's seed, its rank and the step count (a
    resumed run does not replay its masks)."""
    if rank:
        mix = gen.initial_seed() * 0x9E3779B97F4A7C15 + rank * 0xBF58476D1CE4E5B9 + step
        gen.manual_seed(mix % 2**63)
    return gen


@torch.no_grad()
def broadcast_tensors(tensors, src: int = 0, group=None) -> None:
    """``src``'s values of ``tensors`` on every rank of ``group``, in place:
    one broadcast per dtype of the tensors flattened together (one
    collective per tensor, thousands for a model, costs seconds over gloo)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def replicate_state(state, group=None):
    """Rank 0's parameters and buffers (BN statistics) on every rank of
    ``group``, and each rank's dropout generator folded with its rank. The
    optimizer state and the step count are taken as equal on every rank
    (fresh, or loaded from the same checkpoint)."""
    if not dist.is_initialized():
        return state
    src = dist.get_global_rank(group, 0) if group is not None else 0
    broadcast_tensors([t.data for t in itertools.chain(state.model.parameters(),
                                                        state.model.buffers())], src, group)
    fold_generator(state.generator, dist.get_rank(group), state.step)
    return state
