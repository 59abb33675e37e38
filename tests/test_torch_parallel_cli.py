"""Port: the data-parallel train CLI (``--gpus 0-1``) and batch-split serving
(``--mesh``) on the CPU, two gloo rank processes each, at the tiny size.

* train (one pair of launches for the train tests): two ranks run 2
  iterations on a cooked LVIS set (``--data``); rank 0 alone writes the
  log, the history and the checkpoint, which loads strictly into a fresh
  model and resumes for 2 more iterations;
* serve: ``--mesh 2`` writes labels bit-equal to one process's (``--mesh
  0``): each rank serves its contiguous block of every micro-batch, and
  eval-mode BN makes a frame's labels independent of its neighbours;
* the refusals: a batch or micro-batch that does not divide by the ranks,
  and ``--mesh`` with ``--spatial``.
"""

import os
import shutil

import numpy as np
import pytest

from fovealseg_torch.cli import infer as infer_cli
from fovealseg_torch.cli import train as train_cli

TINY = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny"]
TRAIN_FLAGS = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas",
               "64", "--gpus", "0-1", "--timeout", "600"]
SERVE_FLAGS = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas",
               "64", "--num-batches", "2"]


@pytest.fixture(scope="module")
def lvis_runs(tmp_path_factory):
    """Two ranks train on a cooked LVIS set at the global batch (8 samples
    at 2 x 2: two steps per epoch) for one epoch, then resume for a second.
    Rank 0's TensorBoard writer uses TensorBoard's own stand-in for
    TensorFlow here: a ``tensorflow`` that fails to import, on the ranks'
    path, saves each CLI run the ~15-20 s of importing TensorFlow."""
    from fovealseg_torch.cli import cook
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.train import checkpoint as ckpt
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer
    from torch_port_files import lvis_json

    tmp = tmp_path_factory.mktemp("parallel_cli")
    stub = tmp / "stub"
    (stub / "tensorflow").mkdir(parents=True)
    (stub / "tensorflow" / "__init__.py").write_text("raise ImportError('not for this test')\n")
    j, root = lvis_json(str(tmp / "l.json")), tmp / "cook"
    for part, n in (("train", 8), ("valid", 20)):
        assert cook.main(["lvis", f"--{part}-json", j, "--dataset-partition", part,
                          "--out", str(root), "--sample-num", str(n), "--canvas", "64"]) == 0
    d = str(tmp / "run")
    flags = TRAIN_FLAGS + ["--data", str(root)]
    opts = TINY + ["TRAIN.batch_size_per_gpu", "2", "TRAIN.eval_per_epoch", "100",
                   "DATASET.dataset_marker_train", "sp8", "DATASET.dataset_marker_valid", "sp4",
                   "DIR", d]
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(stub))
        first = train_cli.main(flags + opts + ["TRAIN.num_epoch", "1"])
        with open(os.path.join(d, "train.log")) as fh:
            log = fh.read()
        with open(os.path.join(d, "history_epoch_last_0.csv")) as fh:
            history = fh.read()
        files = set(os.listdir(d))
        cfg = train_cli._parse(flags + opts)[1]
        model = DeformSegmentation(DeformConfig.from_cfg(cfg), device="cpu")
        state = S.init_state(model, create_optimizer(cfg, model), 0)
        ckpt.load_checkpoint(d, 1, state)
        resumed = train_cli.main(flags + opts + ["TRAIN.num_epoch", "2",
                                                 "TRAIN.auto_resume", "True"])
    with open(os.path.join(d, "history_epoch_last_0.csv")) as fh:
        history_resumed = fh.read()
    out = dict(first=first, log=log, history=history, files=files, loaded_step=state.step,
               resumed=resumed, history_resumed=history_resumed,
               resumed_files=set(os.listdir(d)))
    shutil.rmtree(d)  # ~1 GB of the tiny model's checkpoints
    return out


def test_train_cli_two_ranks_write_once_and_resume(lvis_runs):
    """Rank 0 alone writes the log, the history and the checkpoint, which
    loads strictly into a fresh model and resumes for a second epoch."""
    ranks = lvis_runs["first"]
    assert [r["step"] for r in ranks] == [2, 2]
    assert [(r["topology"]["rank"], r["topology"]["world_size"], r["topology"]["backend"])
            for r in ranks] == [(0, 2, "gloo"), (1, 2, "gloo")]
    for kind in ("saliency", "compress", "encoder", "decoder", "train_state"):
        for tag in (1, "last"):
            assert f"{kind}_epoch_{tag}.pth" in lvis_runs["files"]
    log = lvis_runs["log"]
    assert "data parallel: 2 ranks over gloo, global batch 4" in log
    assert log.count("Training Done!") == 1  # rank 0's log alone
    assert len(lvis_runs["history"].strip().splitlines()) == 1 + 2
    assert lvis_runs["loaded_step"] == 2
    assert [r["step"] for r in lvis_runs["resumed"]] == [4, 4]
    assert len(lvis_runs["history_resumed"].strip().splitlines()) == 1 + 4
    assert "train_state_epoch_2.pth" in lvis_runs["resumed_files"]


def test_train_cli_two_ranks_on_cooked_lvis(lvis_runs):
    """``--gpus 0-1 --data``: each rank reads its block of every global
    batch (``DatasetLVIS.batches(rank=, world=)``, held to the JAX reader in
    ``test_torch_port_data.py``)."""
    assert [r["step"] for r in lvis_runs["first"]] == [2, 2]
    assert "LVIS cooked data: 8 train / 4 val" in lvis_runs["log"]
    assert "data parallel: 2 ranks over gloo, global batch 4" in lvis_runs["log"]


def _masks(d):
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d)) if n.endswith(".npy")}


def test_mesh_serving_is_bit_equal_to_one_process(tmp_path):
    """``--mesh 2`` at batch 4 with micro-batches of 2 (one frame per rank)
    against one process: the same 8 label maps, bit for bit."""
    common = SERVE_FLAGS + ["--batch", "4", "--microbatch", "2"]
    one = infer_cli.main(common + ["--out", str(tmp_path / "one")] + TINY)
    ranks = infer_cli.main(common + ["--mesh", "2", "--out", str(tmp_path / "two")] + TINY)
    assert len(ranks) == 2 and ranks[0]["frames"] == one["frames"] == 6
    a, b = _masks(tmp_path / "one"), _masks(tmp_path / "two")
    assert list(a) == list(b) and len(a) == 8
    for name in a:
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)


@pytest.mark.parametrize("flags,opts,error", [
    (["--batch", "3", "--mesh", "2"], [], SystemExit),
    (["--batch", "6", "--microbatch", "3", "--mesh", "2"], [], SystemExit),
    (["--batch", "4", "--mesh", "2", "--spatial", "2"], [], SystemExit)])
def test_mesh_serving_refusals(flags, opts, error):
    """Refused before any rank starts (a ``_nonsyn`` saliency net is served
    with ``--mesh`` since the 2-D slice: ``test_torch_parallel_spatial.py``)."""
    with pytest.raises(error):
        infer_cli.main(SERVE_FLAGS + flags + TINY + opts)
