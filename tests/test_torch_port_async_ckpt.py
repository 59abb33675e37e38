"""Port: the overlapped checkpoint write (``train/checkpoint.py::AsyncSaver``,
read by ``train/loop.py::fit`` from ``TPU.async_checkpoint``) on the CPU at
the tiny size (``hrnetv2_nodownsp_tiny``, 16x16 task, batch 2).

It is held against the port's own synchronous write: the JAX package's saver
writes orbax directories, which are not comparable.

* The files of ``save_checkpoint(..., saver=AsyncSaver())`` load bit-equal to
  the synchronous write's, for the numbered tag and ``_last``, and a resume
  from them trains the next step bit-equal to an uninterrupted run.
* The snapshot is taken at ``save()``: an in-place update made while the
  writer waits does not reach the files.
* An error raised in the writer is raised at ``wait()``.
* An interrupted ``_last`` refresh leaves ``has_checkpoint(d, 'last')``
  False, and ``cli/train.py::_resume`` takes the newest numbered epoch.
* The train CLI leaves the same files with the key on and off.

The snapshot, error and interruption tests write a small stand-in with the
four sub-networks (``_Four``, an Adam over four ``Linear``s): the tiny
model's set is ~350 MB per tag.
"""

import logging
import os
import random
import shutil
import threading

import numpy as np
import pytest
import torch

from fovealseg_torch.cli import train as train_cli
from fovealseg_torch.cli.infer import build_model
from fovealseg_torch.configs import get_default_cfg
from fovealseg_torch.data.synthetic import make_batch
from fovealseg_torch.train import checkpoint as ckpt
from fovealseg_torch.train import step as S
from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules
from tests.torch_port_zoo import no_tensorflow  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "fovealseg_torch", "configs", "deform.yaml")
TINY = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
        "TRAIN.batch_size_per_gpu", "2", "TRAIN.epoch_iters", "2", "TPU.compute_dtype", "float32"]
KINDS = ("saliency", "compress", "encoder", "decoder", "train_state")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_file(CFG)
    cfg.merge_from_list(TINY + ["TRAIN.seed", "5", *opts])
    return cfg


def _batch(seed):
    b = make_batch(np.random.default_rng(seed), 2, 64, 50)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _state(seed=5, steps=1):
    """A tiny state and its train step after ``steps`` steps (one sets
    Adam's moments)."""
    cfg = _cfg("TRAIN.seed", str(seed))
    model = build_model(cfg, torch.device("cpu"))
    state = S.init_state(model, create_optimizer(cfg, model), seed)
    step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))
    for _ in range(steps):
        step(state, _batch(1))
    return state, step


class _Four(torch.nn.Module):
    """A stand-in with the four sub-networks of the 4-file set, small enough
    that the tests of the write's order and errors write little."""

    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        for name in ckpt.SUBMODULE_OF_FILE.values():
            setattr(self, name, torch.nn.Linear(6, 3))

    def forward(self, x):
        return sum(getattr(self, n)(x).sum() for n in ckpt.SUBMODULE_OF_FILE.values())


def _small_state(seed=5, steps=1):
    model = _Four(seed)
    state = S.TrainState(model, torch.optim.Adam(model.parameters(), lr=0.1, foreach=True), 0,
                         torch.Generator().manual_seed(seed), random.Random(seed))
    for _ in range(steps):
        state.optimizer.zero_grad()
        model(torch.ones(2, 6)).backward()
        state.optimizer.step()
        state.step += 1
    return state


def _load(d, tag):
    return {k: torch.load(os.path.join(d, f"{k}_epoch_{tag}.pth"), map_location="cpu",
                          weights_only=True) for k in KINDS}


def _assert_same(a, b, where=""):
    """Nested containers equal, tensors bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_async_files_equal_sync_and_resume_is_bit_equal(tmp_path):
    state, step = _state()
    ckpt.save_checkpoint(str(tmp_path / "sync"), 1, state)
    saver = ckpt.AsyncSaver()
    written = ckpt.save_checkpoint(str(tmp_path / "async"), 1, state, saver=saver)
    saver.wait()
    assert sorted(written) == sorted(os.path.join(tmp_path / "async", f"{k}_epoch_{t}.pth")
                                     for t in (1, "last") for k in KINDS)
    for tag in (1, "last"):
        _assert_same(_load(tmp_path / "sync", tag), _load(tmp_path / "async", tag), str(tag))
    assert saver.last_bytes == sum(os.path.getsize(p) for p in written)
    assert saver.last_write_s > 0
    # the _last files are copies of the numbered ones
    for k in KINDS:
        with open(tmp_path / "async" / f"{k}_epoch_1.pth", "rb") as a, \
                open(tmp_path / "async" / f"{k}_epoch_last.pth", "rb") as b:
            assert a.read() == b.read(), k
    saver.close()
    shutil.rmtree(tmp_path / "sync")  # ~1.4 GB between the two sets

    resumed, _ = _state(seed=9, steps=0)  # other weights, other generators: all overwritten
    ckpt.load_checkpoint(str(tmp_path / "async"), "last", resumed)
    shutil.rmtree(tmp_path / "async")
    assert resumed.step == state.step
    nxt = _batch(2)
    step(state, nxt)
    step(resumed, nxt)
    _assert_same(_params(state.model), _params(resumed.model), "after the resumed step")
    _assert_same(state.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"])


def test_snapshot_is_taken_at_save(tmp_path, monkeypatch):
    state = _small_state()
    before = _params(state.model)
    moments = {k: v.clone() for k, v in state.optimizer.state_dict()["state"][0].items()}
    step_before = state.step
    gate = threading.Event()
    write = ckpt._write

    def gated(path, obj):
        gate.wait(30)
        write(path, obj)

    monkeypatch.setattr(ckpt, "_write", gated)
    saver = ckpt.AsyncSaver()
    ckpt.save_checkpoint(str(tmp_path), 4, state, saver=saver)
    with torch.no_grad():  # what the next step's in-place update does
        for p in state.model.parameters():
            p.add_(1.0)
        for v in state.optimizer.state_dict()["state"][0].values():
            v.add_(1.0)
    state.step += 1
    gate.set()
    saver.close()
    for tag in (4, "last"):
        files = _load(tmp_path, tag)
        sd = {f"{ckpt.SUBMODULE_OF_FILE[k]}.{n}": v for k in ckpt.SUBMODULE_OF_FILE
              for n, v in files[k].items()}
        _assert_same(before, sd, str(tag))
        _assert_same(moments, files["train_state"]["optimizer"]["state"][0])
        assert files["train_state"]["step"] == step_before


def test_writer_error_is_raised_at_wait(tmp_path, monkeypatch):
    state = _small_state()

    def broken(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    saver = ckpt.AsyncSaver()
    ckpt.save_checkpoint(str(tmp_path), 1, state, saver=saver)
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    saver.wait()  # raised once, then the saver is drained
    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_checkpoint(str(tmp_path), 2, state, saver=saver)
    with pytest.raises(OSError, match="disk full"):
        saver.close()


def _fail_at(monkeypatch, name, tag, kind="encoder"):
    """Make ``ckpt.<name>`` raise when it writes ``kind`` of ``tag``."""
    real = getattr(ckpt, name)

    def failing(*args):
        if os.path.basename(args[-1] if name == "_copy" else args[0]) == f"{kind}_epoch_{tag}.pth":
            raise OSError("interrupted")
        real(*args)

    monkeypatch.setattr(ckpt, name, failing)


@pytest.mark.parametrize("route", ["sync only_last", "async only_last", "async copy"])
def test_interrupted_last_refresh_is_refused(tmp_path, monkeypatch, route):
    state = _small_state()
    d = str(tmp_path)
    for epoch in (1, 2):
        state.step = 2 * epoch
        ckpt.save_checkpoint(d, epoch, state)
    assert ckpt.has_checkpoint(d, "last")
    state.step = 6
    if route == "async copy":
        _fail_at(monkeypatch, "_copy", "last")
    else:
        _fail_at(monkeypatch, "_write", "last")
    saver = None if route.startswith("sync") else ckpt.AsyncSaver()
    with pytest.raises(OSError, match="interrupted"):
        ckpt.save_checkpoint(d, 3, state, only_last=route != "async copy", saver=saver)
        saver.wait()
    assert not ckpt.has_checkpoint(d, "last")
    newest = 3 if route == "async copy" else 2
    assert ckpt.has_checkpoint(d, newest)

    cfg = _cfg("TRAIN.auto_resume", "True", "DIR", d)
    fresh = _small_state(seed=9, steps=0)
    train_cli._resume(cfg, fresh, logging.getLogger("test"))
    assert fresh.step == 2 * newest and cfg.TRAIN.start_epoch == newest
    _assert_same(_load(d, newest)["encoder"],
                 {k[len("encoder."):]: v for k, v in fresh.model.state_dict().items()
                  if k.startswith("encoder.")})


@pytest.mark.usefixtures("no_tensorflow")
def test_fit_writes_the_same_files_with_the_key_on_and_off(tmp_path):
    flags = ["--cfg", CFG, "--device", "cpu", "--canvas", "64"]
    runs = {}
    for key in ("True", "False"):
        d = tmp_path / key
        train_cli.main(flags + TINY + ["TRAIN.num_epoch", "2", "TRAIN.checkpoint_per_epoch", "2",
                                       "TRAIN.eval_per_epoch", "100",
                                       "TPU.async_checkpoint", key, "DIR", str(d)])
        runs[key] = d
        names = sorted(f for f in os.listdir(d) if f.endswith(".pth"))
        assert names == sorted(f"{k}_epoch_{t}.pth" for k in KINDS for t in (2, "last"))
    for tag in (2, "last"):
        _assert_same(_load(runs["False"], tag), _load(runs["True"], tag), str(tag))
    for d in runs.values():
        shutil.rmtree(d)
