"""Port: ``python -m fovealseg_torch.cli.cook`` against the JAX ``cli/cook.py``,
both in-process, on the cases of ``tests/test_cli_cook.py``: the same return
codes, and cooked trees with the same names and byte-equal contents."""

import importlib.util
import os

import numpy as np
import pytest
from PIL import Image

from fovealseg_torch.cli import cook as port_cook
from test_cli_cook import _tiny_lvis_json
from test_data import _cityscapes_fixture
from test_torch_port_data import assert_same_tree
from torch_port_zoo import no_tensorflow  # noqa: F401

# the TensorBoard writers of the CLIs run here take TensorBoard's stand-in for TensorFlow
pytestmark = pytest.mark.usefixtures("no_tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_cook(argv):
    spec = importlib.util.spec_from_file_location("clicook", os.path.join(REPO, "cli", "cook.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.main(argv)


def both(tmp_path, make_args):
    """Run both CLIs on their own copy of the inputs; return the two output
    roots after checking the return codes agree."""
    rcs, outs = [], []
    for name, main in (("port", port_cook.main), ("jax", jax_cook)):
        d = tmp_path / name
        d.mkdir()
        argv, out = make_args(d)
        rcs.append(main(argv))
        outs.append(out)
    assert rcs[0] == rcs[1] == 0
    return outs


def test_cook_lvis_partitions_and_markers(tmp_path):
    """--sample-num 5 and 10: train markers sp5, sp10 and valid sp1, sp2."""
    def make(d):
        j = _tiny_lvis_json(d)
        return (["lvis", "--train-json", j, "--valid-json", j, "--out", str(d / "cook"),
                 "--sample-num", "5", "10", "--canvas", "128", "--seed", "2"], d)

    port, jax_ = both(tmp_path, make)
    assert sorted(os.listdir(port / "cook" / "train")) == ["sp10", "sp5"]
    assert sorted(os.listdir(port / "cook" / "valid")) == ["sp1", "sp2"]
    assert len(os.listdir(port / "cook" / "valid" / "sp2")) == 2
    assert_same_tree(port, jax_)


@pytest.mark.parametrize("argv", [["--dataset-partition", "train"],
                                  ["--dataset-partition", "test", "--train-json", "x.json"]],
                         ids=["missing_json", "unknown_partition"])
def test_cook_lvis_rejects(tmp_path, argv):
    for main in (port_cook.main, jax_cook):
        with pytest.raises(SystemExit):
            main(["lvis", "--out", str(tmp_path), "--sample-num", "5", *argv])


@pytest.mark.parametrize("extra", [["--n", "19", "--marker", "m19"], []], ids=["n19", "all"])
def test_cook_cityscapes(tmp_path, extra):
    def make(d):
        gtfine = _cityscapes_fixture(d)
        return (["cityscapes", "--gtfine", gtfine, "--out", str(d / "cook"), *extra,
                 "--canvas", "(100,200)", "--crop", "(50,100)", "--seed", "1"], d / "cook")

    assert_same_tree(*both(tmp_path, make))


def test_cook_cityscapes_rgb(tmp_path):
    from fovealseg_torch.data.cityscapes import RGBLABEL_ROWS

    def make(d):
        xd, yd = d / "x", d / "y"
        xd.mkdir(), yd.mkdir()
        frame = np.random.default_rng(0).integers(0, 255, (8, 12, 3), np.uint8)
        label = np.zeros((8, 12, 3), np.uint8)
        label[2:6, 3:9] = RGBLABEL_ROWS[1][2]
        Image.fromarray(frame).save(xd / "city_000000_000019_leftImg8bit.png")
        Image.fromarray(label).save(yd / "city_000000_000019_gtFine_color.png")
        return (["cityscapes-rgb", "--x-dir", str(xd), "--y-dir", str(yd),
                 "--out", str(d / "cook"), "--crop", "(8,12)"], d / "cook")

    assert_same_tree(*both(tmp_path, make))


def test_cook_aria_summary(tmp_path):
    from fovealseg_torch.data.aria_adt import info2fname

    def make(d):
        cache = d / "cache"
        cache.mkdir()
        for i in range(2):
            name = info2fname(dict(fid=[i], cat="mug", gz=[3, 4 + i], sp=[3, 8, 8]))
            Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(cache / f"{name}.png")
        return ["aria-summary", "--cache-dir", str(cache)], cache

    port, jax_ = both(tmp_path, make)
    # the summary names each frame by its path, which differs between the copies
    lines = [(p / "smry.json").read_text().replace(str(p), "<cache>") for p in (port, jax_)]
    assert lines[0] == lines[1] and lines[0].count("\n") == 2


def test_cook_cityscapes_then_train(tmp_path):
    """cook -> train: the port's train CLI takes the cooked Cityscapes layout
    (``<root>/<partition>/<marker>``) and reconciles ``TRAIN.epoch_iters`` to
    one pass over it (3 samples at batch 2: one step per epoch)."""
    import torch

    from fovealseg_torch.cli import train as train_cli

    gtfine = _cityscapes_fixture(tmp_path)
    root = tmp_path / "cook"
    for part in ("train", "valid"):
        assert port_cook.main(["cityscapes", "--gtfine", gtfine, "--out", str(root / part),
                               "--n", "19", "--marker", "m4", "--canvas", "(100,200)",
                               "--crop", "(32,64)", "--seed", "1"]) == 0
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        state = train_cli.main([
            "--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu",
            "--data", str(root), "--dataset", "cityscapes",
            "TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
            "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
            "TRAIN.batch_size_per_gpu", "2", "DATASET.num_class", "21",
            "DATASET.dataset_marker_train", "m4", "DATASET.dataset_marker_valid", "m4",
            "TRAIN.num_epoch", "1", "TRAIN.epoch_iters", "5", "DIR", str(tmp_path / "run")])
    finally:
        torch.set_num_threads(prev)
    assert state.step == 1
    assert (tmp_path / "run" / "encoder_epoch_last.pth").exists()
    assert (tmp_path / "run" / "eval_history.csv").exists()
