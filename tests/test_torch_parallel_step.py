"""Port: cross-rank BN and the data-parallel train and eval steps against the
JAX package's ``shard_map`` steps, on the CPU.

The port runs two gloo rank processes (``parallel/launch.py``), 4 samples
per rank of a global b8 batch; the JAX package runs ``shard_map`` on 2 of
the 8 virtual CPU devices (``tests/conftest.py``). The tiny configuration
of ``tests/test_multiprocess.py`` (``hrnetv2_nodownsp_tiny``, 16x16 task,
radius 5, 64x64 canvas) with dropout off on both sides (flax's
``Dropout.__call__`` patched here, the port's in the ranks), weights carried
over with ``from_jax_variables``; SGD, so that an update's norm measures its
gradient; ``MODEL.uniform_sample='BI'`` with the joint edge loss, so that
the warped image is bit-equal on both sides and all four groups train (the
configuration of ``tests/test_torch_port_train.py``'s three-step test: with
the learned warp, one pixel's label flips where a grid coordinate straddles
an integer, and on this batch the single-process steps of the two packages
already differ by 1.7e-4 in the loss and ~5% in each group's update).

Tolerances, and why:

* BN alone: the output, the running statistics and the input, scale and
  bias gradients to 1e-5 relative to their largest value (f32 sums over 50
  values in another order);
* the train step: the metrics to 1e-5 relative (``tests/test_torch_port_train.py``
  holds one step's loss so); each group's update within 5% of its norm (the
  single-device SGD step's tolerance there: the tiny encoder's train-mode
  BN over 16 values per channel amplifies the last bits of its input), the
  saliency and compress groups' within 5e-3 (the three-step test's), the BN
  statistics' update within 1e-3 of its norm;
* the eval step: every metric to 1e-4 relative (``tests/test_parallel.py``
  holds the JAX package's own sharded eval to 1e-4);
* one rank under DDP against the single-process step in the same process,
  two steps, in the configuration above and with the learned warp:
  bit-equal (a one-rank all-reduce and a division by 1 are exact).

Per-rank loss normalisation (edge loss, Dice) is both packages' semantics
(``tests/test_parallel.py``), so the loss is compared as it is.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
from fovealseg_tpu.data.synthetic import make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.models.layers import batch_norm as jax_batch_norm
from fovealseg_tpu.parallel.mesh import (make_mesh, make_parallel_eval_step,
                                         make_parallel_train_step, replicate_state, shard_batch)
from fovealseg_tpu.train.optim import create_optimizer as jax_create_optimizer
from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
from fovealseg_tpu.train.step import TrainState as JaxTrainState
from fovealseg_torch.parallel.launch import run_workers
from fovealseg_torch.train.checkpoint import from_jax_variables
from fovealseg_torch.train.optim import GROUPS

import torch_parallel_workers as W

OPTS = ["TRAIN.optim", "sgd", "MODEL.uniform_sample", "BI", "TRAIN.deform_joint_loss", "True"]
METRICS = ("loss", "dice_loss", "focal_loss", "edge_loss", "acc", "acc_bin_fg", "acc_cls_fbg",
           "acc_bin_fbg")


@pytest.fixture(autouse=True, scope="module")
def _no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        yield


def jax_cfg():
    c = jax_default_cfg()
    c.merge_from_file("fovealseg_torch/configs/deform.yaml")
    c.merge_from_list(W.TINY_OPTS + OPTS)
    c.TRAIN.max_iters = c.TRAIN.epoch_iters * c.TRAIN.num_epoch
    return c


@pytest.fixture(scope="module")
def init():
    """The global b8 batch and the JAX PRNGKey(0) variables."""
    batch = make_batch(np.random.default_rng(41), 8, canvas=64)
    jm = JaxDeform(config=JaxConfig.from_cfg(jax_cfg()))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batch["img_data"][:2]),
                         jnp.asarray(batch["focus_point"][:2]))
    return batch, jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def port(init, tmp_path_factory):
    """Futures of the port's two ranks (eval step, train step with
    cross-rank BN on and off, checkpoint writes) and of one rank under DDP
    beside the plain step: the rank processes run while the JAX steps
    compile in this process."""
    batch, v = init
    sd = from_jax_variables(v["params"], v["batch_stats"])
    root = tmp_path_factory.mktemp("dp")
    with ThreadPoolExecutor(2) as pool:
        yield (pool.submit(run_workers, 2, W.data_parallel, sd, batch, OPTS, str(root),
                           device="cpu", timeout=600, threads=1),
               pool.submit(run_workers, 1, W.world_one, sd, batch, [OPTS, OPTS[:2]],
                           device="cpu", timeout=600, threads=1))


def _jax_step(v, batch, sync: bool):
    jc = jax_cfg()
    module = JaxDeform(config=JaxConfig.from_cfg(jc), axis_name="data" if sync else None)
    tx = jax_create_optimizer(jc)
    mesh = make_mesh(2)
    state = replicate_state(JaxTrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                          jnp.int32(0)), mesh)
    step = make_parallel_train_step(module, tx, JaxLossConfig.from_cfg(jc), mesh)
    new, mets = step(state, shard_batch({k: jnp.asarray(x) for k, x in batch.items()}, mesh),
                     jax.random.PRNGKey(1))
    return ({k: float(x) for k, x in mets.items()},
            from_jax_variables(jax.tree.map(np.asarray, new.params),
                               jax.tree.map(np.asarray, new.batch_stats)))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _by_group(sd: dict, stats: bool) -> dict:
    out = {}
    for name, sub, _, _ in GROUPS:
        keys = sorted(k for k in sd if k.startswith(sub + ".") and "num_batches" not in k
                      and ("running_" in k) == stats)
        out[name] = np.concatenate([np.asarray(sd[k], np.float64).reshape(-1) for k in keys]
                                   or [np.zeros(0)])
    return out


def _update_errors(old, got, ref) -> dict:
    """{group or 'bn_stats': the port's update's distance from the JAX
    update, relative to its norm}."""
    out = {}
    for stats in (False, True):
        g, r, o = _by_group(got, stats), _by_group(ref, stats), _by_group(old, stats)
        for name in g:
            if o[name].size:
                out[f"{name}{' stats' if stats else ''}"] = _rel(g[name] - o[name],
                                                                 r[name] - o[name])
    return out


def test_sync_bn_matches_flax_cross_replica_bn():
    """One BN layer, train mode, two gloo ranks against flax ``BatchNorm``
    with ``axis_name`` under ``shard_map`` on two devices: output, running
    statistics, input / scale / bias gradients of sum(y * g), per rank."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 3, 5, 5)) * 2 + 1).astype(np.float32)  # NCHW, 2 per rank
    g = rng.normal(size=x.shape).astype(np.float32)
    w, b = rng.uniform(0.5, 1.5, 3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    mean, var = rng.normal(size=3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(np.float32)
    ranks = run_workers(2, W.sync_bn, x, g, w, b, mean, var, device="cpu", timeout=120,
                        threads=1)

    bn = jax_batch_norm(axis_name="d", train=True)
    variables = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    def per_device(variables, xs, gs):
        def loss(params, xs):
            y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xs,
                              mutable=["batch_stats"])
            return jnp.sum(y * gs), (y, mut["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], xs)
        return y, stats, jax.tree.map(lambda t: t[None], gp), gx

    mesh = make_mesh(2, axis="d")
    y, stats, gp, gx = jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=(P(), P("d"), P("d")),
        out_specs=(P("d"), P(), P("d"), P("d")), check_vma=False))(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(g.transpose(0, 2, 3, 1)))
    y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
    for r, got in enumerate(ranks):
        blk = slice(2 * r, 2 * r + 2)
        for name, ref in (("y", y[blk]), ("dx", gx[blk]), ("dw", np.asarray(gp["scale"])[r]),
                          ("db", np.asarray(gp["bias"])[r]),
                          ("running_mean", stats["mean"]), ("running_var", stats["var"])):
            assert _max_rel(got[name].numpy(), ref) <= 1e-5, (r, name)


@pytest.mark.parametrize("sync", [True, False], ids=["sync_bn", "local_bn"])
def test_train_step_matches_jax_parallel_step(init, port, sync):
    """One data-parallel SGD step, the port's two gloo ranks against
    ``make_parallel_train_step`` on a 2-device mesh: the metrics averaged
    over the ranks, the updated parameters and BN statistics (rank 0's: the
    JAX step returns device 0's statistics when BN is local)."""
    batch, v = init
    mets, ref = _jax_step(v, batch, sync)
    two = port[0].result()
    got = two[0][f"sd_{sync}"]
    for k in METRICS:
        np.testing.assert_allclose(float(two[0][f"train_{sync}"][k]), mets[k], rtol=1e-5,
                                   err_msg=k)
    tol = {"encoder": 0.05, "decoder": 0.05, "saliency": 5e-3, "compress": 5e-3}
    errs = _update_errors(from_jax_variables(v["params"], v["batch_stats"]), got, ref)
    for name, err in errs.items():
        assert err <= (1e-3 if name.endswith("stats") else tol[name]), (name, err)
    # the ranks agree on the metrics, and on the parameters, bit for bit
    for k in METRICS:
        assert float(two[1][f"train_{sync}"][k]) == float(two[0][f"train_{sync}"][k])
    for k, t in two[1][f"sd_{sync}"].items():
        if sync or "running_" not in k:
            torch.testing.assert_close(t, got[k], rtol=0, atol=0, msg=k)


def test_sync_and_local_bn_steps_differ(port):
    """Cross-rank BN changes the step: the statistics, the loss and the
    updated encoder differ between the synced and the local step, and the
    local step's ranks keep statistics of their own."""
    two = port[0].result()
    on, off = two[0]["sd_True"], two[0]["sd_False"]
    stats = [k for k in on if "running_var" in k]
    assert max(_rel(on[k], off[k]) for k in stats) > 1e-3
    assert float(two[0]["train_True"]["loss"]) != float(two[0]["train_False"]["loss"])
    enc = [k for k in on if k.startswith("encoder.") and "running_" not in k]
    assert max(float((on[k] - off[k]).abs().max()) for k in enc) > 0
    assert any(not torch.equal(two[1]["sd_False"][k], off[k]) for k in stats)


def test_eval_step_matches_jax_parallel_eval_step(init, port):
    batch, v = init
    jc = jax_cfg()
    module = JaxDeform(config=JaxConfig.from_cfg(jc), axis_name="data")
    mesh = make_mesh(2)
    step = make_parallel_eval_step(module, JaxLossConfig.from_cfg(jc), mesh)
    rv = replicate_state(v, mesh)
    ref = step(rv["params"], rv["batch_stats"],
               shard_batch({k: jnp.asarray(x) for k, x in batch.items()}, mesh))
    two = port[0].result()
    for k in METRICS:
        np.testing.assert_allclose(float(two[0]["eval"][k]), float(ref[k]), rtol=1e-4, err_msg=k)
        assert float(two[1]["eval"][k]) == float(two[0]["eval"][k])


def test_rank_0_alone_writes_the_checkpoint(port):
    two = port[0].result()
    assert len(two[0]["written"]) == 10 and two[1]["written"] == []


def test_one_rank_under_ddp_is_the_single_process_step(port):
    """World size 1, two steps: the DDP step (the gradient all-reduce, the
    metrics' all-reduce, the rank's folded generator) gives the
    single-process step's loss, parameters and BN statistics bit for bit,
    with DDP's search for unreached parameters (uniform 'BI') and without it
    (the learned warp reaches every parameter)."""
    (one,) = port[1].result()
    assert [res["unused_parameters"] for res in one] == [True, False]
    for res in one:
        assert res["plain_mets"] == res["ddp_mets"]
        for k, t in res["plain_sd"].items():
            torch.testing.assert_close(res["ddp_sd"][k], t, rtol=0, atol=0, msg=k)
