"""Port: the train CLI (``python -m fovealseg_torch.cli.train``) on the CPU at
the tiny size (``hrnetv2_nodownsp_tiny``, 64x64 synthetic canvas, 16x16
task, batch 2, 2 iterations per epoch), in-process.

* The history CSVs have the JAX CLI's columns: the JAX package's own
  ``train/loop.py::fit`` is run with stand-in steps (no model) and its files'
  headers are compared with the port's.
* Resuming from ``epoch_last`` (``TRAIN.auto_resume``) after one epoch gives
  parameters, BN statistics and history files bit-equal to an uninterrupted
  two-epoch run: the optimizer state, the step, the dropout generator and
  the per-epoch data seeds all carry over.
* The four weight files load into the JAX package through its own
  ``train/checkpoint.py::load_torch_checkpoint``, value for value.
* The eval CLI's ``TRAIN.start_epoch`` loads the same checkpoint as
  ``--torch-ckpt``, with the same result.
"""

import csv
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train import loop as jax_loop
from fovealseg_tpu.train.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from fovealseg_torch.cli import eval as eval_cli
from fovealseg_torch.cli import train as train_cli
from fovealseg_torch.train.checkpoint import from_jax_variables
from tests.torch_port_zoo import no_tensorflow  # noqa: F401

# the TensorBoard writers of the CLIs run here take TensorBoard's stand-in for TensorFlow
pytestmark = pytest.mark.usefixtures("no_tensorflow")

TINY = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
        "TRAIN.batch_size_per_gpu", "2", "TRAIN.epoch_iters", "2", "TPU.compute_dtype", "float32"]
FLAGS = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def train(d, *opts):
    return train_cli.main(FLAGS + TINY + ["DIR", str(d), *opts])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted two-epoch run, and one epoch then a resumed second."""
    root = tmp_path_factory.mktemp("train_cli")
    full = train(root / "full", "TRAIN.num_epoch", "2")
    train(root / "split", "TRAIN.num_epoch", "1")
    resumed = train(root / "split", "TRAIN.num_epoch", "2", "TRAIN.auto_resume", "True")
    return root, full, resumed


def _header(path):
    with open(path, newline="") as fh:
        return next(csv.reader(fh))


def test_history_columns_equal_the_jax_clis(runs, tmp_path):
    """The JAX package's fit, driven by stand-in steps, writes the reference
    schema; the port's files carry the same columns."""
    root, _, _ = runs
    cfg = jax_default_cfg()
    cfg.merge_from_list(["TRAIN.num_epoch", "1", "TRAIN.epoch_iters", "2",
                         "TRAIN.save_checkpoint", "False", "DIR", str(tmp_path)])
    cfg.TRAIN.max_iters = 2

    def step(state, batch, rng):
        return state, {"loss": jnp.float32(1.0), "acc": jnp.float32(0.5),
                       "edge_loss": jnp.float32(0.1)}

    def eval_step(params, batch_stats, batch):
        return {k: jnp.float32(0.5) for k in ("loss", "acc", "edge_loss", "acc_bin_fg",
                                              "acc_cls_fbg", "acc_bin_fbg")}

    jax_loop.fit(cfg, types.SimpleNamespace(params=None, batch_stats=None), step, eval_step,
                 lambda e: iter([{}, {}]), lambda: iter([{}]), rng=jax.random.PRNGKey(0))
    for name in ("history_epoch_last_0.csv", "eval_history.csv"):
        assert _header(root / "full" / name) == _header(tmp_path / name), name


def test_resume_is_bit_equal_to_an_uninterrupted_run(runs):
    root, full, resumed = runs
    assert full.step == resumed.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    for name in ("history_epoch_last_0.csv", "eval_history.csv"):
        with open(root / "full" / name) as f1, open(root / "split" / name) as f2:
            a, b = list(csv.reader(f1)), list(csv.reader(f2))
        # a resumed run re-reads the earlier rows as floats (epoch "1" -> "1.0"),
        # as the JAX package's loop does
        assert a[0] == b[0] and [[float(v) for v in r] for r in a[1:]] == \
            [[float(v) for v in r] for r in b[1:]], name
    with open(root / "full" / "history_epoch_last_0.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [float(r["epoch"]) for r in rows] == [0.5, 1.0, 1.5, 2.0]
    files = set(os.listdir(root / "full"))
    for kind in ("saliency", "compress", "encoder", "decoder", "train_state"):
        assert {f"{kind}_epoch_2.pth", f"{kind}_epoch_last.pth"} <= files
        assert f"{kind}_epoch_1.pth" not in files  # off-cadence: only the _last files
        assert f"{kind}_epoch_1.pth" in set(os.listdir(root / "split"))


def test_weight_files_load_into_the_jax_package(runs):
    root, full, _ = runs
    x = jnp.zeros((1, 64, 64, 3))
    f = jnp.full((1, 2), 0.5)
    v = jax.jit(JaxDeform(config=JaxConfig(task_hw=(16, 16), saliency_hw=(16, 16),
                                           gaussian_radius=5,
                                           arch_encoder="hrnetv2_nodownsp_tiny")).init)(
        jax.random.PRNGKey(0), x, f)
    params, stats = jax_load_torch_checkpoint(str(root / "full"), 2, v["params"], v["batch_stats"])
    loaded = from_jax_variables(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    sd = full.model.state_dict()
    assert set(loaded) == set(sd)
    for k, t in loaded.items():
        if "num_batches" not in k:
            torch.testing.assert_close(t, sd[k], rtol=0, atol=0, msg=k)


def test_eval_cli_resumes_from_the_training_checkpoint(runs):
    root, _, _ = runs
    base = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
            "--num-batches", "1"]
    opts = TINY[:8] + ["VAL.batch_size", "2", "TPU.compute_dtype", "float32"]
    by_epoch = eval_cli.main(base + opts + ["TRAIN.start_epoch", "2", "DIR", str(root / "full")])
    by_ckpt = eval_cli.main(base + ["--torch-ckpt", str(root / "full"), "--torch-epoch", "2"]
                            + opts + ["DIR", str(root / "eval_ckpt")])
    assert by_epoch == by_ckpt


def test_intrinsic_only_updates_no_parameter(tmp_path):
    """``MODEL.gt_gradient_intrinsic_only``: forward and metrics, no update;
    the BN running statistics still move and the step count advances."""
    state = train(tmp_path, "TRAIN.num_epoch", "1", "MODEL.gt_gradient", "True",
                  "MODEL.gt_gradient_intrinsic_only", "True", "TRAIN.save_checkpoint", "False")
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    fresh = init_weights(DeformSegmentation(DeformConfig(task_hw=(16, 16), saliency_hw=(16, 16),
                                                         gaussian_radius=5,
                                                         arch_encoder="hrnetv2_nodownsp_tiny"),
                                            device="cpu"), torch.Generator().manual_seed(304))
    ref, got = fresh.state_dict(), state.model.state_dict()
    assert state.step == 2
    for k, p in ref.items():
        if "running_" in k:
            continue
        torch.testing.assert_close(got[k], p, rtol=0, atol=0, msg=k)
    assert any(not torch.equal(got[k], ref[k]) for k in ref if "running_mean" in k)


def cook_lvis(tmp_path, n_train, **json_kw):
    """A cooked LVIS root on a 64 canvas: ``n_train`` train samples (marker
    ``sp{n_train}``) and 2 valid (marker ``sp2``); ``json_kw`` goes to
    ``lvis_json``."""
    from fovealseg_torch.cli import cook
    from torch_port_files import lvis_json

    j, root = lvis_json(str(tmp_path / "l.json"), **json_kw), tmp_path / "cook"
    for part, n in (("train", n_train), ("valid", 10)):
        assert cook.main(["lvis", f"--{part}-json", j, "--dataset-partition", part,
                          "--out", str(root), "--sample-num", str(n), "--canvas", "64"]) == 0
    return ["--data", str(root)], ["DATASET.dataset_marker_train", f"sp{n_train}",
                                   "DATASET.dataset_marker_valid", "sp2"]


@pytest.mark.parametrize("extra", [["--gpus", "0,1", "--backend", "nccl"],
                                   ["--gpus", "0,1", "TPU.mesh_shape", "(2,2)"],
                                   ["TPU.quantize", "int8"], ["TPU.conv_pack", "True"],
                                   ["--data", "cooked"], ["--data", "too small"],
                                   ["--data", "class out of range"]])
def test_train_cli_refuses_what_it_does_not_run(tmp_path, extra):
    """Unported options raise NotImplementedError. ``--gpus`` naming two
    devices trains data-parallel (``tests/test_torch_parallel_cli.py``);
    what it refuses is NCCL between CPU ranks, a ValueError raised before
    any rank starts. ``TPU.mesh_shape`` trains on the 2-D mesh
    (``tests/test_torch_parallel_2d.py``); what it refuses is a ``--gpus``
    list that does not name one device per rank, a ValueError raised before
    any rank starts. ``--data`` (refused until the readers were ported)
    trains on a cooked set: 3 samples at batch 2 reconcile
    ``TRAIN.epoch_iters`` 2 to one step; a set smaller than the global batch
    exits, as the JAX CLI does; a monitored LVIS id whose training id does
    not fit the 51 classes raises before the model is built."""
    if extra[0] == "--data":
        if extra[1] == "class out of range":
            from fovealseg_torch.data.lvis import CIDS_MONITORED, convert_index

            wide = next(c for c in CIDS_MONITORED if convert_index(c) > 50)
            flags, opts = cook_lvis(tmp_path, 3, cids=[wide])
            args = flags + FLAGS + TINY + ["DIR", str(tmp_path / "run"), *opts]
            with pytest.raises(ValueError, match=rf"training ids \[{convert_index(wide)}\] do "
                                                 r"not fit DATASET.num_class=51"):
                train_cli.main(args)
            assert not os.path.exists(tmp_path / "run" / "decoder_epoch_1.pth")
            return
        flags, opts = cook_lvis(tmp_path, 3 if extra[1] == "cooked" else 1)
        args = flags + FLAGS + TINY + ["DIR", str(tmp_path / "run"), "TRAIN.num_epoch", "1",
                                       *opts]
        if extra[1] == "cooked":
            state = train_cli.main(args)
            assert state.step == 1
            assert os.path.exists(tmp_path / "run" / "decoder_epoch_1.pth")
        else:
            with pytest.raises(SystemExit, match="too small for the global batch"):
                train_cli.main(args)
        return
    flags, opts = (extra, []) if extra[0].startswith("--") else ([], extra)
    if "TPU.mesh_shape" in extra:  # the flag, then the option
        flags, opts = extra[:2], extra[2:]
    with pytest.raises(ValueError if extra[0] == "--gpus" else NotImplementedError):
        train_cli.main(flags + FLAGS + TINY + ["DIR", str(tmp_path), *opts])
