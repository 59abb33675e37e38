"""Data parallelism and the 2-D (data, model) mesh (counterpart of
``fovealseg_tpu/parallel/mesh.py``; its spatial partitioning is
``parallel/spatial.py``).

**1-D.** The JAX package wraps its train step in ``shard_map`` over a 1-D 'data'
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

**2-D.** ``TPU.mesh_shape (dp, mp)``: the JAX package's GSPMD step on
``Mesh(devices.reshape(dp, mp), ('data', 'model'))`` is the one-device step
on the global batch, with the wide weights sharded over 'model'. The port
runs dp * mp ranks; rank ``d * mp + m`` sits at data index d and model
index m (:func:`make_mesh_2d`, one process group per data index and one per
model index, made once):

* :func:`model_sharded` is ``_model_leaf_spec`` in PyTorch's layout: a conv
  (OIHW) or ``Linear`` ([out, in]) weight whose output channels (dim 0) are
  at least ``min_channels`` and divide by mp; model rank m holds the
  contiguous block ``[m * C / mp, (m + 1) * C / mp)``. Everything else is
  replicated;
* :func:`shard_model_2d` swaps those layers for the column-parallel ones of
  ``parallel/tensor_parallel.py``, syncs BN over the data group and takes
  the ``_nonsyn`` nets' batch statistics over it (GSPMD's statistics are the
  global batch's, whatever ``TPU.sync_bn`` says);
* the batch is split over the data indices only: each data index holds
  ``batch_size_per_gpu * mp`` samples (:func:`shard_batch` with the data
  index);
* the step (``train/step.py``, given ``mesh=``) takes the loss and the
  metrics of the global batch (:class:`BatchReduce`), draws the global
  batch's dropout mask (``models/layers.py::batch_block``) and **sums** the
  gradients over the data group (:func:`sum_gradients`); the optimizer
  updates the local shards, so the Adam moments of a sharded weight are
  shard-sized, as JAX's are;
* :func:`gather_state_2d` gives the full tensors (checkpoints are written
  from them by global rank 0) and :func:`slice_state_2d` cuts a full
  (one-process) checkpoint into this rank's shards.
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# collectives that run on gloo (CPU and CUDA tensors) and on NCCL alike


def all_gather_tensors(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on every rank), in rank order, on
    ``t``'s device. Gloo gathers host copies (it moves CUDA tensors only in
    an all-reduce) and the bytes of 16-bit floats."""
    world = dist.get_world_size(group)
    if world == 1:
        return [t]
    t = t.contiguous()
    # gloo gathers no 16-bit floats: their bytes travel
    wire = t.view(torch.uint8) if t.dtype in (torch.bfloat16, torch.float16) else t
    if dist.get_backend(group) == "gloo" and t.is_cuda:
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(parts, wire, group=group)
    return [p.to(t.device).view(t.dtype) for p in parts]


# ---------------------------------------------------------------------------
# 2-D (data, model) mesh


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place on a dp x mp grid and its two process groups:
    ``data_group`` (the dp ranks of its model index) and ``model_group``
    (the mp ranks of its data index)."""

    dp: int
    mp: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object

    @property
    def reduce(self) -> "BatchReduce":
        return BatchReduce(self.data_group, self.dp)


def make_mesh_2d(dp: int, mp: int, ranks=None) -> Mesh2D | None:
    """The dp x mp grid over ``ranks`` (default: every rank of the world, which
    must then number dp * mp): ``ranks[d * mp + m]`` sits at data index d and
    model index m, as ``Mesh(devices.reshape(dp, mp))`` places device d * mp +
    m. Every rank of the world must call this (each group is made by all);
    a rank outside ``ranks`` gets None."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if len(ranks) != dp * mp:
        raise ValueError(f"a {dp}x{mp} mesh needs {dp * mp} ranks, was given {len(ranks)} "
                         f"(world size {world})")
    me = dist.get_rank()
    mine = {}
    for d in range(dp):  # one group per data index: its model ranks
        members = [ranks[d * mp + m] for m in range(mp)]
        g = dist.new_group(members)
        if me in members:
            mine["model"] = g
    for m in range(mp):  # one group per model index: its data ranks
        members = [ranks[d * mp + m] for d in range(dp)]
        g = dist.new_group(members)
        if me in members:
            mine["data"] = g
    if me not in ranks:
        return None
    d, m = divmod(ranks.index(me), mp)
    return Mesh2D(dp, mp, d, m, mine["data"], mine["model"])


def model_sharded(name: str, tensor: torch.Tensor, mp: int, min_channels: int = 256) -> bool:
    """``_model_leaf_spec`` in PyTorch's layout: a conv or ``Linear`` weight
    (``name`` ends in 'weight', at least 2 dimensions) whose output channels,
    dim 0 here (the last axis of flax's HWIO or [in, out] kernel), are at
    least ``min_channels`` and divide by ``mp``."""
    return (name.endswith("weight") and tensor.dim() >= 2 and tensor.shape[0] >= min_channels
            and tensor.shape[0] % mp == 0)


def shard_model_2d(model: torch.nn.Module, mesh: Mesh2D, min_channels: int = 256) -> int:
    """The counterpart of ``shard_state_2d`` for a model: in place, every
    layer whose weight :func:`model_sharded` selects becomes column-parallel
    over the model group (holding its block of output channels), BN is
    synced over the data group and the ``_nonsyn`` nets' batch statistics
    are taken over it (mp 1 shards nothing). Build the optimizer after
    this. Returns the number of layers sharded."""
    from fovealseg_torch.models.layers import convert_sync_bn, set_batch_stats_group
    from fovealseg_torch.parallel.tensor_parallel import column_parallel

    n = (column_parallel(model, mesh.model_group, mesh.model_index, mesh.mp, min_channels)
         if mesh.mp > 1 else 0)
    convert_sync_bn(model, mesh.data_group)
    set_batch_stats_group(model, mesh.data_group)
    return n


class _SumOwnGradient(torch.autograd.Function):
    """The sum over the ranks of a group, read by the same (replicated)
    arithmetic on every rank: its backward hands each rank the gradient of
    its own term, as every rank computes the same global loss from it."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GlobalExtremum(torch.autograd.Function):
    """The global extremum ``value``, read by every rank's own block: its
    backward sums the ranks' gradients and hands this rank its ``share`` of
    them at ``local`` (its own extremum)."""

    @staticmethod
    def forward(ctx, local, value, share, group):
        ctx.share, ctx.group = share, group
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return total * ctx.share, None, None, None


class BatchReduce:
    """Reductions over the global batch of a data group, each rank holding an
    equal block. :meth:`sum` and :meth:`avg` (of per-rank means) feed the
    same arithmetic on every rank, so a rank's gradient reaches its own
    terms only; the extrema :meth:`min` and :meth:`max` feed each rank's own
    block, so their gradient is summed over the ranks and reaches the
    elements that hold the extremum, split evenly among them as JAX splits
    a tie. The losses of ``core/losses.py`` take one as ``reduce``."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else _SumOwnGradient.apply(t, self.group)

    def avg(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.size == 1 else self.sum(t) / self.size

    def _extremum(self, t: torch.Tensor, op, local) -> torch.Tensor:
        m = local(t)
        if self.size == 1:
            return m
        with torch.no_grad():
            g = m.detach().clone()
            dist.all_reduce(g, op=op, group=self.group)
            ties = (t.detach() == g).sum().to(torch.float32).reshape(1)
            share = ties.clone()
            dist.all_reduce(share, group=self.group)
            share = (ties / share)[0].to(m.dtype)
        return _GlobalExtremum.apply(m, g, share, self.group)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return self._extremum(t, dist.ReduceOp.MIN, torch.min)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._extremum(t, dist.ReduceOp.MAX, torch.max)


@torch.no_grad()
def sum_gradients(model: torch.nn.Module, group) -> None:
    """Every gradient of ``model`` summed over the ranks of ``group`` in place
    (one all-reduce per dtype of the gradients flattened together): the
    ranks of a data group each differentiate through their own block."""
    if dist.get_world_size(group) == 1:
        return
    by_dtype: dict = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def _shard_of(p: torch.Tensor):
    """(model index, parts) of a sharded parameter, else None."""
    return getattr(p, "model_shard", None)


def _optimizer_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


@torch.no_grad()
def gather_state_2d(model: torch.nn.Module, optimizer, mesh: Mesh2D) -> tuple[dict, dict | None]:
    """(model state dict, optimizer state dict) with every sharded tensor
    gathered whole over the model group, copied to the host: the keys and
    shapes of a one-process run (no optimizer given: None in its place).
    Every rank must call it (collective)."""
    sd = {}
    for k, v in model.state_dict(keep_vars=True).items():
        t = v.detach()
        if _shard_of(v) is not None:
            t = torch.cat(all_gather_tensors(t, mesh.model_group))
        sd[k] = t.to("cpu", copy=True)
    if optimizer is None:
        return sd, None
    osd = optimizer.state_dict()
    params = _optimizer_params(optimizer)
    state = {}
    for idx, entry in osd["state"].items():
        p = params[idx]
        state[idx] = {}
        for name, v in entry.items():
            if _shard_of(p) is not None and torch.is_tensor(v) and v.shape == p.shape:
                v = torch.cat(all_gather_tensors(v, mesh.model_group))
            state[idx][name] = v.to("cpu", copy=True) if torch.is_tensor(v) else v
    return sd, {**osd, "state": state}


def slice_state_2d(model: torch.nn.Module, optimizer, sd: dict | None,
                   osd: dict | None) -> tuple[dict | None, dict | None]:
    """The inverse of :func:`gather_state_2d`: full (one-process) state dicts
    cut to this rank's shards of the sharded parameters, ready for
    ``load_state_dict``."""
    own = model.state_dict(keep_vars=True)

    def cut(v, p):
        shard = _shard_of(p)
        if shard is None or not torch.is_tensor(v) or v.dim() == 0:
            return v
        m, parts = shard
        if v.shape[0] != p.shape[0] * parts:
            raise ValueError(f"a full tensor of {tuple(v.shape)} does not shard into "
                             f"{parts} blocks of {tuple(p.shape)}")
        n = p.shape[0]
        return v[m * n:(m + 1) * n].clone()

    out_sd = None if sd is None else {k: cut(v, own[k]) if k in own else v for k, v in sd.items()}
    out_osd = None
    if osd is not None:
        params = _optimizer_params(optimizer)
        out_osd = {**osd, "state": {idx: {name: cut(v, params[int(idx)])
                                          for name, v in entry.items()}
                                    for idx, entry in osd["state"].items()}}
    return out_sd, out_osd
