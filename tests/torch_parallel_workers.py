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


# --------------------------------------------------------------------------
# the 2-D (data, model) mesh and row-partitioned serving


def tiny_model(sd, config, dtype=torch.float32):
    """A ``DeformSegmentation`` of ``config`` holding copies of ``sd``'s
    tensors, built on the meta device (PyTorch's own init of ~29 M
    parameters costs a rank a second or two)."""
    from fovealseg_torch.models.deform_module import DeformSegmentation

    with torch.device("meta"):
        model = DeformSegmentation(config, dtype=dtype, device="meta")
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    model.device = torch.device("cpu")
    return model


def tiny_state(sd, cfg, mesh=None, seed: int = 0):
    """The tiny model from ``sd``, sharded over ``mesh`` when given, its
    optimizer and a fresh state (the dropout generator seeded with
    ``seed``)."""
    from fovealseg_torch.models.deform_module import DeformConfig
    from fovealseg_torch.parallel.mesh import shard_model_2d
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer

    model = tiny_model(sd, DeformConfig.from_cfg(cfg))
    sharded = shard_model_2d(model, mesh) if mesh is not None else 0
    state = S.init_state(model, create_optimizer(cfg, model), seed, mesh=mesh)
    return state, sharded


def digest(sd: dict) -> str:
    """A hash of the bytes of every tensor of ``sd``, in key order."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def one_step(sd, batch, opts, mesh=None, dropout: bool = True) -> dict:
    """One train step of the tiny model from ``sd`` on the global ``batch``
    (this data index's block on a mesh), edge scale 100: the metrics, the
    updated state dict (gathered whole on a mesh; on a mesh only the first
    rank returns it, every rank its digest) and the layers sharded."""
    from fovealseg_torch.models import layers
    from fovealseg_torch.parallel.mesh import gather_state_2d, shard_batch
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import make_stage_schedules

    cfg = port_cfg(*opts)
    state, sharded = tiny_state(sd, cfg, mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        tb = shard_batch(tb, mesh.data_index, mesh.dp)
    step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg), mesh=mesh)
    forward = layers.Dropout.forward
    if not dropout:
        layers.Dropout.forward = lambda self, x: x
    try:
        mets = step(state, {**tb, "edge_scale": 100.0})
    finally:
        layers.Dropout.forward = forward
    if mesh is None:
        out_sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    else:
        out_sd = gather_state_2d(state.model, state.optimizer, mesh)[0]
    first = mesh is None or (mesh.data_index, mesh.model_index) == (0, 0)
    return {"mets": {k: float(v) for k, v in mets.items()}, "sd": out_sd if first else None,
            "digest": digest(out_sd), "sharded": sharded}


def _mismatches(got: dict, ref: dict, cut=None) -> list:
    """The keys of ``got`` and ``ref`` whose values differ (tensors bit for
    bit), or that one of them lacks; ``cut(key, ref value, got value)``
    slices a full reference to a shard."""
    bad = sorted(set(ref) ^ set(got))
    for k in sorted(got.keys() & ref.keys()):
        t, r = got[k], ref[k] if cut is None else cut(k, ref[k], got[k])
        if torch.is_tensor(t):
            if not (torch.is_tensor(r) and t.shape == r.shape and torch.equal(t, r)):
                bad.append(k)
        elif t != r:
            bad.append(k)
    return bad


def mesh_2d(r, sd, batch, opts, root):
    """Every 2-D case of ``tests/test_torch_parallel_2d.py`` on four ranks, in
    three rounds:

    * dp 2 x mp 2, one SGD step with dropout on, and one with dropout off
      (against the JAX step);
    * dp 1 x mp 2 on ranks 0-1 beside dp 2 x mp 1 on ranks 2-3;
    * on ranks 0-1, checkpoints at dp 1 x mp 2 with Adam: rank 0 writes a
      one-process checkpoint (one step) into ``root/one``; it loads into the
      mesh (this rank's shards returned); one 2-D step; its checkpoint
      written (by rank 0, gathered) into ``root/two`` and loaded back into a
      fresh 2-D state (equal to the state that wrote it, shard for shard).
      Beside it, on ranks 2-3, dp 2 x mp 1 with the gradients averaged over
      the data group instead of summed (the fault the test must see)."""
    from fovealseg_torch.parallel import mesh as mesh_lib
    from fovealseg_torch.parallel.mesh import make_mesh_2d, shard_batch
    from fovealseg_torch.train import checkpoint as ckpt
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import make_stage_schedules

    grid = make_mesh_2d(2, 2)
    out = {"place": (grid.data_index, grid.model_index)}
    out["2x2"] = one_step(sd, batch, opts, grid)
    out["2x2_no_dropout"] = one_step(sd, batch, opts, grid, dropout=False)
    # every rank makes every group, members or not
    wide = make_mesh_2d(1, 2, ranks=[0, 1])
    tall = make_mesh_2d(2, 1, ranks=[2, 3])
    if r.rank >= 2:
        out["2x1"] = one_step(sd, batch, opts, tall)
        total = mesh_lib.sum_gradients

        def mean_gradients(model, group):
            total(model, group)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(dist.get_world_size(group))

        mesh_lib.sum_gradients = mean_gradients
        try:
            out["2x1_mean"] = one_step(sd, batch, opts, tall)
        finally:
            mesh_lib.sum_gradients = total
        return out
    out["1x2"] = one_step(sd, batch, opts, wide)

    cfg = port_cfg(*opts, "TRAIN.optim", "adam")
    tb = {**{k: torch.from_numpy(v) for k, v in batch.items()}, "edge_scale": 100.0}
    schedules = make_stage_schedules(cfg)
    lcfg = S.LossConfig.from_cfg(cfg)
    one_dir, two_dir = os.path.join(root, "one"), os.path.join(root, "two")
    if r.rank == 0:
        one, _ = tiny_state(sd, cfg)
        S.make_train_step(lcfg, schedules)(one, tb)
        ckpt.save_checkpoint(one_dir, 1, one, only_last=True)
        del one
    dist.barrier(wide.model_group)
    # the one-process checkpoint into the mesh: this rank's row blocks
    state, _ = tiny_state(sd, cfg, wide)
    ckpt.load_checkpoint(one_dir, "last", state)
    files = {}
    for kind, sub in ckpt.SUBMODULE_OF_FILE.items():
        part = torch.load(os.path.join(one_dir, f"{kind}_epoch_last.pth"), weights_only=True)
        files.update({f"{sub}.{k}": v for k, v in part.items()})
    full_opt = torch.load(os.path.join(one_dir, "train_state_epoch_last.pth"),
                          weights_only=True)["optimizer"]["state"]
    m = wide.model_index

    def cut(key, full, local):
        if not torch.is_tensor(full) or full.shape == local.shape:
            return full
        n = local.shape[0]
        assert full.shape[0] == 2 * n, key
        return full[m * n:(m + 1) * n]

    out["sharded_keys"] = sorted(k for k, v in state.model.state_dict().items()
                                 if v.shape != files[k].shape)
    out["from_one"] = _mismatches(state.model.state_dict(), files, cut)
    local_opt = state.optimizer.state_dict()["state"]
    out["from_one_optimizer"] = ([] if local_opt.keys() == full_opt.keys() else ["keys"]) + [
        (i, n) for i in local_opt for n in local_opt[i]
        if _mismatches({n: local_opt[i][n]}, {n: full_opt[i][n]}, cut)]
    out["from_one_step"] = state.step
    # one step on the mesh; its checkpoint (rank 0 writes the gathered tensors)
    S.make_train_step(lcfg, schedules, mesh=wide)(state, shard_batch(tb, 0, 1))
    out["written"] = ckpt.save_checkpoint(two_dir, 2, state, only_last=True)
    sd2, osd2 = mesh_lib.gather_state_2d(state.model, state.optimizer, wide)
    # ... back into the mesh: the shards that wrote it
    again, _ = tiny_state(sd, cfg, wide)
    ckpt.load_checkpoint(two_dir, "last", again)
    out["reload"] = _mismatches(again.model.state_dict(), state.model.state_dict())
    a, b = again.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    out["reload_optimizer"] = [(i, n) for i in b for n in b[i]
                               if _mismatches({n: a[i][n]}, {n: b[i][n]})]
    # ... and into one process: the gathered tensors
    if r.rank == 0:
        single, _ = tiny_state(sd, cfg)
        ckpt.load_checkpoint(two_dir, "last", single)
        out["into_one_step"] = single.step
        out["into_one"] = _mismatches(single.model.state_dict(), sd2)
        got = single.optimizer.state_dict()["state"]
        out["into_one_optimizer"] = [(i, n) for i in osd2["state"] for n in osd2["state"][i]
                                     if _mismatches({n: got[i][n]}, {n: osd2["state"][i][n]})]
    return out


def spatial_serve(r, sd, x, f, cfg_kw):
    """The tiny model from ``sd`` row-partitioned over the four ranks and over
    ranks 0-1 (a group of two; ranks 2-3 wait): the eval forward's ``pred``
    and ``infer``'s scores and labels, with the exchanges of one frame batch.
    oneDNN is off: it picks a strided conv's algorithm by the input's
    height, so a row block would round unlike the whole image."""
    from fovealseg_torch.models.deform_module import DeformConfig
    from fovealseg_torch.parallel import spatial

    torch.backends.mkldnn.enabled = False
    model = tiny_model(sd, DeformConfig(**cfg_kw))
    pair = dist.new_group([0, 1])
    out = {}
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    for name, group in (("4", dist.group.WORLD), ("2", pair)):
        if r.rank >= 2 and name == "2":
            continue
        model.set_spatial(group)
        before = spatial.exchanges
        with torch.no_grad():
            res = {"pred_forward": model(xt, ft)["pred"]}
            n = spatial.exchanges - before
            res.update({k: v for k, v in model.infer(xt, ft).items()
                        if k in ("pred", "pred_sampled")})
            res["pred_label"] = model.infer(xt, ft, argmax_labels=True)["pred_label"]
        res["exchanges_forward"] = n
        out[name] = res
    dist.barrier()
    return out


def cut_port_builder(mit: dict) -> None:
    """The port's builder in this process cut as
    ``tests/torch_port_zoo.py::cut_encoders`` cuts it: ``segformer`` builds
    the MiT config ``mit``, ``deeplab`` one Bottleneck per layer, both with
    drop path off."""
    from fovealseg_torch.models import builder
    from fovealseg_torch.models.deeplab import DeepLabEncoder
    from fovealseg_torch.models.segformer import SegFormerEncoder

    build = builder.build_encoder

    def cut(arch, fc_dim=960, dtype=torch.float32):
        if arch == "segformer":
            return SegFormerEncoder(mit, drop_path_rate=0.0, dtype=dtype)
        if arch == "deeplab":
            return DeepLabEncoder(dtype=dtype, layers=(1, 1, 1, 1))
        return build(arch, fc_dim, dtype)

    builder.build_encoder = cut


def row_ops(group, ops: dict) -> dict:
    """The row hooks of ``models/layers.py`` on this rank's rows of the whole
    inputs ``ops``, each case on a fresh ``RowShards`` of ``group``: this
    rank's output block (the max pools, the rate-36 conv) or the whole
    result (the gathers, the mean), and each case's exchanges."""
    from fovealseg_torch.models import layers
    from fovealseg_torch.parallel import spatial

    conv = layers.conv2d(8, 8, 3, 1, 36, dilation=36)
    conv.load_state_dict(ops["conv_state"])
    spatial.row_aware(conv)

    def zero_fill(rows):
        fetch = rows._fetch
        rows._fetch = lambda x, n, needs, fill=0.0: fetch(x, n, needs, 0.0)
        return rows

    pool = lambda x: layers.trunk_max_pool(x, 3, 2, 1)  # noqa: E731
    cases = {  # name: (task height, input, op, RowShards -> RowShards)
        "max_pool": (9, "pool9", pool, None),
        "max_pool_zero_fill": (9, "pool9", pool, zero_fill),
        "max_pool_empty": (16, "pool2", pool, None),
        "gather": (9, "map9", layers.trunk_gather, None),
        "gather_empty": (16, "pool2", layers.trunk_gather, None),
        "gather_tokens": (9, "map9", lambda x: layers.trunk_gather(
            x.flatten(2).transpose(1, 2), tuple(x.shape[-2:])), None),
        "mean": (9, "map9", lambda x: layers.trunk_mean(x, keepdim=True), None),
        "mean_empty": (16, "pool2", lambda x: layers.trunk_mean(x, keepdim=True), None),
        "conv_rate36": (80, "conv10", conv, None),
    }
    out = {}
    with torch.no_grad():
        for name, (height, key, op, adapt) in cases.items():
            rows = spatial.RowShards(group)
            if adapt is not None:
                rows = adapt(rows)
            before = spatial.exchanges
            with rows.running(height):
                out[name] = op(rows.shard(ops[key]))
            out[f"{name}_exchanges"] = spatial.exchanges - before
        out["conv_rate36_whole"] = conv(ops["conv10"])
    return out


def spatial_encoders(r, sds, x, f, cfgs, mit, ops):
    """Row-partitioned serving of the cut SegFormer and DeepLab
    (``cut_port_builder``) over the four ranks and over ranks 0-1 (a group
    of two; ranks 2-3 wait): per encoder the eval forward's ``pred``,
    ``infer``'s scores and labels and the forward's exchanges, in f32 over
    both groups and in bf16 over four ranks; and ``row_ops`` over both
    groups. oneDNN is off in f32, as in ``spatial_serve``, and on in bf16:
    PyTorch's own CPU convs take tens of seconds for the cut DeepLab's
    dilated convs in bf16."""
    from fovealseg_torch.models.deform_module import DeformConfig
    from fovealseg_torch.parallel import spatial

    torch.backends.mkldnn.enabled = False
    cut_port_builder(mit)
    pair = dist.new_group([0, 1])
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    out = {}
    for name, group in (("4", dist.group.WORLD), ("2", pair)):
        if r.rank >= 2 and name == "2":
            continue
        res = {"ops": row_ops(group, ops)}
        for enc, sd in sds.items():
            for dt in ("float32", "bfloat16") if name == "4" else ("float32",):
                torch.backends.mkldnn.enabled = dt == "bfloat16"
                model = tiny_model(sd, DeformConfig(**cfgs[enc]), getattr(torch, dt))
                model.set_spatial(group)
                before = spatial.exchanges
                with torch.no_grad():
                    got = {"pred_forward": model(xt, ft)["pred"]}
                    got["exchanges_forward"] = spatial.exchanges - before
                    got.update({k: v for k, v in model.infer(xt, ft).items()
                                if k in ("pred", "pred_sampled")})
                    got["pred_label"] = model.infer(xt, ft, argmax_labels=True)["pred_label"]
                res[f"{enc} {dt}"] = got
        out[name] = res
    dist.barrier()
    return out


def spatial_pair_on_card(r, sd, config, mit, x, f):
    """Row-partitioned argmax serving of the model of ``config`` with a cut
    encoder (``cut_port_builder``) on this rank's card, TF32 off: its
    labels and K1's launches."""
    from fovealseg_torch.ops import jfa

    cut_port_builder(mit)
    model = tiny_model(sd, config).to(r.device)
    model.device = r.device
    model.set_spatial(dist.group.WORLD)
    before = jfa.nearest_class.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.no_grad():
        label = model.infer(torch.from_numpy(x).to(r.device), torch.from_numpy(f).to(r.device),
                            argmax_labels=True)["pred_label"]
    torch.cuda.synchronize()
    return {"label": label.cpu(), "k1": jfa.nearest_class.launches - before}
