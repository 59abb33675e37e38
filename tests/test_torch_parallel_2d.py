"""Port: the 2-D (data, model) mesh (``TPU.mesh_shape``) on the CPU, gloo
rank processes, at the tiny size.

The configuration of ``tests/test_torch_parallel_step.py``: the tiny
``hrnetv2_nodownsp_tiny``, 16x16 task, radius 5, 64x64 canvas, a global b8
batch; SGD (an update's norm measures its gradient); ``MODEL.uniform_sample
'BI'`` with the joint edge loss, so that all four groups train. The weights
are the JAX package's variables filled from a numpy seed
(``tests/torch_port_zoo.py::seeded_variables``, no XLA compile), carried
over with ``from_jax_variables``.

One launch of four ranks (``torch_parallel_workers.py::mesh_2d``) runs every
2-D case while this process runs the references:

* (1) the port's one-process step on the same global batch and generator,
  dropout on (the 2-D step draws the global batch's mask), at dp x mp =
  2x2, 1x2 and 2x1: the metrics within rtol 1e-4, the updated parameters
  within rtol 2e-3 and atol 2e-5 (``tests/test_parallel.py:145-151``, the
  JAX package's own tolerances for its GSPMD step), and each group's update
  within 5% of its norm, which a gradient off by a factor of dp or mp
  fails; the 2x1 step with the gradients averaged over the data group
  instead of summed must fail it;
* (2) the JAX ``make_gspmd_train_step`` at dp 2 x mp 2 on the CPU mesh of
  ``tests/conftest.py``, dropout off on both sides, to the tolerances of
  ``test_torch_parallel_step.py`` (the metrics to 1e-5 relative; each
  group's update within 5% of its norm, saliency and compress within 5e-3;
  the BN statistics within 1e-3);
* (3) the flagship at full width: the parameters ``model_sharded`` selects
  are, by torch key, the leaves that ``state_shardings_2d`` puts on 'model'
  (shapes from ``jax.eval_shape``);
* checkpoints (Adam, dp 1 x mp 2): a one-process checkpoint loads into the
  mesh as slices of its tensors, the mesh's checkpoint (gathered, written
  by rank 0 alone) loads into one process with the gathered tensors and
  back into the mesh equal to the state that wrote it;
* the train CLI with ``TPU.mesh_shape '(2,2)'``: 2 epochs of 2 steps, rank 0
  writes once, and it resumes.
"""

import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
from fovealseg_tpu.data.synthetic import make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.parallel.mesh import (make_gspmd_train_step, make_mesh_2d, shard_state_2d,
                                         state_shardings_2d)
from fovealseg_tpu.train.optim import create_optimizer as jax_create_optimizer
from fovealseg_tpu.train.step import LossConfig as JaxLossConfig
from fovealseg_tpu.train.step import TrainState as JaxTrainState
from fovealseg_torch.cli import train as train_cli
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.parallel.launch import run_workers
from fovealseg_torch.parallel.mesh import model_sharded
from fovealseg_torch.train import checkpoint as ckpt
from fovealseg_torch.train.checkpoint import from_jax_variables
from fovealseg_torch.train.optim import GROUPS

import torch_parallel_workers as W
from torch_port_zoo import seeded_variables

OPTS = ["TRAIN.optim", "sgd", "MODEL.uniform_sample", "BI", "TRAIN.deform_joint_loss", "True"]
METRICS = ("loss", "dice_loss", "focal_loss", "edge_loss", "acc", "acc_bin_fg", "acc_cls_fbg",
           "acc_bin_fbg")
TINY = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny"]


def jax_cfg():
    c = jax_default_cfg()
    c.merge_from_file("fovealseg_torch/configs/deform.yaml")
    c.merge_from_list(W.TINY_OPTS + OPTS)
    c.TRAIN.max_iters = c.TRAIN.epoch_iters * c.TRAIN.num_epoch
    return c


def _no_tensorflow(root) -> str:
    """A ``tensorflow`` that fails to import: rank 0's TensorBoard writer then
    skips TensorFlow's ~15-20 s import (``test_torch_parallel_cli.py``)."""
    stub = root / "stub"
    (stub / "tensorflow").mkdir(parents=True)
    (stub / "tensorflow" / "__init__.py").write_text("raise ImportError('not for this test')\n")
    return str(stub)


def _train_cli(d: str):
    """The train CLI on the 2x2 mesh: one epoch, then a resumed second."""
    flags = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
             "--timeout", "600"]
    opts = TINY + ["TPU.mesh_shape", "(2,2)", "TRAIN.batch_size_per_gpu", "1",
                   "TRAIN.epoch_iters", "2", "TRAIN.eval_per_epoch", "100", "DIR", d]
    first = train_cli.main(flags + opts + ["TRAIN.num_epoch", "1"])
    second = train_cli.main(flags + opts + ["TRAIN.num_epoch", "2", "TRAIN.auto_resume", "True"])
    return first, second


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The seeded weights, the global b8 batch, and the futures of the four
    ranks and of the train CLI, which run while the references compute
    here."""
    jc = jax_cfg()
    jm = JaxDeform(config=JaxConfig.from_cfg(jc))
    batch = make_batch(np.random.default_rng(41), 8, canvas=64)
    v = seeded_variables(jm, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)), seed=5)
    sd = from_jax_variables(v["params"], v["batch_stats"])
    root = tmp_path_factory.mktemp("mesh2d")
    # on the path before the launches: the ranks' path is this process's
    stub = _no_tensorflow(root)
    sys.path.insert(0, stub)
    try:
        with ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(run_workers, 4, W.mesh_2d, sd, batch, OPTS, str(root),
                                device="cpu", timeout=600, threads=1)
            cli = pool.submit(_train_cli, str(root / "cli"))
            yield dict(v=v, sd=sd, batch=batch, root=root, ranks=ranks, cli=cli)
    finally:
        sys.path.remove(stub)


@pytest.fixture(scope="module")
def single(setup):
    """The port's one-process SGD step on the global batch, dropout on (on
    one thread: eight rank processes share the host meanwhile)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.one_step(setup["sd"], setup["batch"], OPTS)
    finally:
        torch.set_num_threads(prev)


def _by_group(sd: dict, stats: bool) -> dict:
    out = {}
    for name, sub, _, _ in GROUPS:
        keys = sorted(k for k in sd if k.startswith(sub + ".") and "num_batches" not in k
                      and ("running_" in k) == stats)
        out[name] = np.concatenate([np.asarray(sd[k], np.float64).reshape(-1) for k in keys]
                                   or [np.zeros(0)])
    return out


def _update_errors(old, got, ref) -> dict:
    """{group or '<group> stats': the distance of ``got``'s update from
    ``ref``'s, relative to the norm of ``ref``'s}."""
    out = {}
    for stats in (False, True):
        g, r, o = _by_group(got, stats), _by_group(ref, stats), _by_group(old, stats)
        for name in g:
            if o[name].size:
                du, dr = g[name] - o[name], r[name] - o[name]
                out[f"{name}{' stats' if stats else ''}"] = float(
                    np.linalg.norm(du - dr) / max(np.linalg.norm(dr), 1e-300))
    return out


def _held(got: dict, ref: dict, old: dict) -> list:
    """The failures of the 2-D step ``got`` against the one-process step
    ``ref``: metrics (rtol 1e-4), parameters (rtol 2e-3, atol 2e-5), each
    group's update (5% of its norm)."""
    bad = []
    for k in METRICS:
        if not np.isclose(got["mets"][k], ref["mets"][k], rtol=1e-4, atol=0):
            bad.append((k, got["mets"][k], ref["mets"][k]))
    for k, t in ref["sd"].items():
        if t.is_floating_point() and not np.allclose(got["sd"][k].numpy(), t.numpy(),
                                                     rtol=2e-3, atol=2e-5):
            bad.append(k)
    for name, err in _update_errors(old, got["sd"], ref["sd"]).items():
        if not name.endswith("stats") and err > 0.05:
            bad.append((name, err))
    return bad


@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_2d_step_is_the_one_process_step_on_the_global_batch(setup, single, shape):
    """Dropout on: the 2-D step draws the global batch's mask, so it is the
    one-process step on the global batch with the same generator. Every
    rank of the mesh ends with the same whole model and metrics."""
    ranks = setup["ranks"].result()
    sub = [r[shape] for r in ranks if shape in r]
    assert len(sub) == (4 if shape == "2x2" else 2)
    got = sub[0]
    assert (got["sharded"] == 0) == (shape == "2x1")  # nothing to shard over one model rank
    assert _held(got, single, setup["sd"]) == []
    assert all(o["mets"] == got["mets"] and o["digest"] == got["digest"] for o in sub[1:])
    if shape == "2x1":
        # the step that averages the gradients over the data group fails the check
        bad = _held(ranks[2]["2x1_mean"], single, setup["sd"])
        assert {b[0] for b in bad if isinstance(b, tuple)} >= {g[0] for g in GROUPS}, bad


def test_2d_step_matches_jax_gspmd_step(setup):
    """dp 2 x mp 2, dropout off on both sides: the port's four ranks against
    ``make_gspmd_train_step`` on a (2, 2) mesh of the virtual CPU devices."""
    v, batch = setup["v"], setup["batch"]
    jc = jax_cfg()
    module = JaxDeform(config=JaxConfig.from_cfg(jc))
    tx = jax_create_optimizer(jc)
    mesh = make_mesh_2d(dp=2, mp=2)
    state = shard_state_2d(JaxTrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                         jnp.int32(0)), mesh)
    step = make_gspmd_train_step(module, tx, JaxLossConfig.from_cfg(jc), mesh, state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        new, mets = step(state, {k: jnp.asarray(x) for k, x in batch.items()},
                         jax.random.PRNGKey(1))
    ref = from_jax_variables(jax.tree.map(np.asarray, new.params),
                             jax.tree.map(np.asarray, new.batch_stats))
    got = setup["ranks"].result()[0]["2x2_no_dropout"]
    assert all(r["2x2_no_dropout"]["digest"] == got["digest"] for r in setup["ranks"].result())
    for k in METRICS:
        np.testing.assert_allclose(got["mets"][k], float(mets[k]), rtol=1e-5, err_msg=k)
    tol = {"encoder": 0.05, "decoder": 0.05, "saliency": 5e-3, "compress": 5e-3}
    for name, err in _update_errors(setup["sd"], got["sd"], ref).items():
        assert err <= (1e-3 if name.endswith("stats") else tol[name]), (name, err)


def test_flagship_sharded_set_is_jax_model_axis():
    """Full width: ``model_sharded`` at mp 2 picks, by torch key, exactly the
    parameters that ``state_shardings_2d`` shards over 'model'."""
    jm = JaxDeform(config=JaxConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 640, 640, 3)),
                            jnp.zeros((1, 2)))["params"]
    specs = state_shardings_2d(shapes, make_mesh_2d(dp=4, mp=2))
    jax_keys = set()
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if "model" in str(sh.spec):
            keys = [p.key for p in path]
            assert keys[-1] == "kernel", keys
            jax_keys.add(".".join(keys[:-1]) + ".weight")
    with torch.device("meta"):
        model = DeformSegmentation(DeformConfig(), device="meta")
    port_keys = {k for k, p in model.named_parameters() if model_sharded(k, p, 2)}
    assert len(port_keys) > 100
    assert port_keys == jax_keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_column_parallel_shards_keep_the_weights_dtype(dtype):
    """Each model rank's shard is its contiguous block of output channels in
    the weight's own dtype (a float64 copy of a net stays float64)."""
    from fovealseg_torch.models.layers import conv2d, linear
    from fovealseg_torch.parallel.tensor_parallel import column_parallel

    net = torch.nn.Sequential(conv2d(8, 256, 3, 1, 1, dtype=dtype), linear(8, 512, dtype)).to(dtype)
    full = {k: v.clone() for k, v in net.state_dict().items()}
    assert column_parallel(net, None, 1, 2) == 2
    for k, v in net.state_dict().items():
        assert v.dtype == dtype, k
        n = v.shape[0]
        assert torch.equal(v, full[k][n:2 * n] if k.endswith("weight") else full[k]), k


def test_checkpoints_cross_between_2d_and_one_process(setup):
    """Adam, dp 1 x mp 2 (the comparisons run in the ranks, bit for bit): the
    one-process checkpoint loads into the mesh as its row blocks (the
    moments too); the mesh's checkpoint, written once from the gathered
    tensors, loads into one process with them, and back into the mesh with
    the shards that wrote it."""
    ranks = setup["ranks"].result()[:2]
    for r in ranks:
        assert r["from_one_step"] == 1
        assert r["sharded_keys"] and r["sharded_keys"] == ranks[0]["sharded_keys"]
        for key in ("from_one", "from_one_optimizer", "reload", "reload_optimizer"):
            assert r[key] == [], (key, r[key][:5])
    assert len(ranks[0]["written"]) == 5 and ranks[1]["written"] == []
    assert ranks[0]["into_one_step"] == 2
    assert ranks[0]["into_one"] == [] and ranks[0]["into_one_optimizer"] == []


def test_train_cli_on_the_2d_mesh_writes_once_and_resumes(setup):
    first, second = setup["cli"].result()
    d = str(setup["root"] / "cli")
    assert [r["step"] for r in first] == [2] * 4 and [r["step"] for r in second] == [4] * 4
    assert [r["topology"]["world_size"] for r in first] == [4] * 4
    with open(os.path.join(d, "train.log")) as fh:
        log = fh.read()
    assert log.count("2-D mesh: dp=2 x mp=2 over gloo") == 2  # rank 0's, in each run
    assert log.count("Training Done!") == 2
    with open(os.path.join(d, "history_epoch_last_0.csv")) as fh:
        assert len(fh.read().strip().splitlines()) == 1 + 4
    for kind in ("saliency", "compress", "encoder", "decoder", "train_state"):
        for tag in (1, 2, "last"):
            assert os.path.exists(os.path.join(d, f"{kind}_epoch_{tag}.pth"))
    # the checkpoint is a one-process run's: it loads strictly into one process
    cfg = train_cli._parse(["--cfg", "fovealseg_torch/configs/deform.yaml", *TINY])[1]
    model = DeformSegmentation(DeformConfig.from_cfg(cfg), device="cpu")
    ckpt.load_torch_checkpoint(model, d, 2, strict=True)
    shutil.rmtree(d)
