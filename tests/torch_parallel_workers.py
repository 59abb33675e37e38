"""Rank functions for the data-parallel tests of the port
(``tests/test_torch_parallel*.py``), run by
``fovealseg_torch.parallel.launch.run_workers``. They import torch and the
port only: the JAX side of each comparison runs in the test process."""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

TINY_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
             "TRAIN.epoch_iters", "10"]


def port_cfg(*opts):
    from fovealseg_torch.configs import get_default_cfg

    c = get_default_cfg()
    c.merge_from_file("fovealseg_torch/configs/deform.yaml")
    c.merge_from_list(TINY_OPTS + list(opts))
    c.TRAIN.max_iters = c.TRAIN.epoch_iters * c.TRAIN.num_epoch
    return c


def _no_dropout():
    from fovealseg_torch.models import layers

    layers.Dropout.forward = lambda self, x: x


def sync_bn(r, x, g, w, b, mean, var):
    """One ``layers.BatchNorm2d`` in train mode over the ranks: this rank's
    block of ``x`` [N, C, H, W] and of the upstream gradient ``g``; returns
    the output, the running statistics and the input, weight and bias
    gradients of ``sum(y * g)``."""
    from fovealseg_torch.models.layers import BatchNorm2d, convert_sync_bn
    from fovealseg_torch.parallel.mesh import shard_batch

    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    assert convert_sync_bn(bn, dist.group.WORLD) == 1
    blk = shard_batch({"x": torch.from_numpy(x), "g": torch.from_numpy(g)}, r.rank, r.world_size)
    xb = blk["x"].clone().requires_grad_(True)
    bn.train()
    y = bn(xb)
    (y * blk["g"]).sum().backward()
    return {"y": y.detach(), "dx": xb.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _state(sd, cfg, sync: bool):
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import convert_sync_bn
    from fovealseg_torch.parallel.mesh import replicate_state
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer

    model = DeformSegmentation(DeformConfig.from_cfg(cfg), device="cpu")
    model.load_state_dict(sd, strict=True)
    if sync:
        convert_sync_bn(model, dist.group.WORLD)
    return replicate_state(S.init_state(model, create_optimizer(cfg, model), 0))


def data_parallel(r, sd, batch, opts, ckpt_root):
    """From the weights ``sd``, on this rank's block of the global
    ``batch``: the data-parallel eval step, then one data-parallel train step
    with cross-rank BN on and one with it off (dropout off). Returns their
    metrics and the updated state dicts, and which checkpoint files this rank
    wrote through ``save_checkpoint`` into its own directory under
    ``ckpt_root``."""
    from fovealseg_torch.parallel.mesh import shard_batch
    from fovealseg_torch.train import checkpoint as ckpt
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import make_stage_schedules

    _no_dropout()
    cfg = port_cfg(*opts)
    lcfg = S.LossConfig.from_cfg(cfg)
    block = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, r.rank,
                        r.world_size)
    out = {}
    state = _state(sd, cfg, sync=True)
    out["eval"] = S.make_eval_step(lcfg, group=dist.group.WORLD)(state, block)
    for sync in (True, False):
        state = _state(sd, cfg, sync)
        t = time.perf_counter()
        mets = S.make_train_step(lcfg, make_stage_schedules(cfg), group=dist.group.WORLD)(
            state, block)
        out[f"step_s_{sync}"] = time.perf_counter() - t
        out[f"train_{sync}"] = mets
        out[f"sd_{sync}"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        assert state.step == 1
    d = os.path.join(ckpt_root, f"rank{r.rank}")
    out["written"] = ckpt.save_checkpoint(d, 1, state)
    shutil.rmtree(d, ignore_errors=True)  # ~0.5 GB of the tiny model's files
    return out


def world_one(r, sd, batch, opt_sets):
    """On one rank, for each configuration in ``opt_sets``: the
    single-process train step and the data-parallel one (DDP over the
    one-rank group), each from the weights ``sd`` for two steps on the whole
    ``batch`` (a parameter that the loss leaves unreached makes DDP without
    its search raise in the second); their metrics and updated state dicts,
    and whether DDP searched for unreached parameters."""
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import make_stage_schedules

    _no_dropout()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for opts in opt_sets:
        cfg = port_cfg(*opts)
        lcfg = S.LossConfig.from_cfg(cfg)
        res = {"unused_parameters": lcfg.unused_parameters}
        for name, group in (("plain", None), ("ddp", dist.group.WORLD)):
            state = _state(sd, cfg, sync=True)
            step = S.make_train_step(lcfg, make_stage_schedules(cfg), group=group)
            mets = [{k: float(v) for k, v in step(state, tb).items()} for _ in range(2)]
            res[f"{name}_mets"] = mets
            res[f"{name}_sd"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        out.append(res)
    return out


def topology(r):
    from fovealseg_torch.parallel.multihost import describe_topology

    return describe_topology(r.device)


def fail_on_rank_1(r):
    """Rank 1 raises at once; rank 0 waits in a collective that never
    completes."""
    if r.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return float(t)


def replicate(r):
    """A conv (weight in channels-last strides), a BN (f32 statistics, an
    int64 count) and an f64 parameter filled with rank-dependent values,
    then ``replicate_state``: returns the state dict and two dropout draws."""
    import types

    from fovealseg_torch.parallel.mesh import replicate_state

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    model.register_parameter("extra", torch.nn.Parameter(torch.zeros(5, dtype=torch.float64)))
    model[0].weight.data = model[0].weight.data.to(memory_format=torch.channels_last)
    with torch.no_grad():
        for i, t in enumerate(model.state_dict().values()):
            t.copy_(torch.arange(t.numel()).reshape(t.shape) * (r.rank + 1) + i)
    gen = torch.Generator().manual_seed(7)
    replicate_state(types.SimpleNamespace(model=model, generator=gen, step=3))
    assert not model[0].weight.is_contiguous()
    return {"sd": {k: v.clone() for k, v in model.state_dict().items()},
            "draw": torch.rand(4, generator=gen)}


def print_a_lot(r, n_bytes):
    """Print ``n_bytes`` to stdout before returning (more than a pipe holds)."""
    line = "x" * 99 + "\n"
    for _ in range(n_bytes // 100):
        os.write(1, line.encode())
    return r.rank


def block_sum(r, arr):
    """This rank's contiguous block of ``arr``, summed over the ranks."""
    from fovealseg_torch.parallel.mesh import shard_batch

    blk = shard_batch({"a": torch.from_numpy(arr)}, r.rank, r.world_size)["a"]
    total = blk.sum().reshape(1).double()
    dist.all_reduce(total)
    return {"block": blk, "total": float(total), "expected": float(np.sum(arr))}


def sleep_forever(r):
    while True:
        time.sleep(1)
