"""Port: the serving CLI (``python -m fovealseg_torch.cli.infer``) end to end
on the CPU with the tiny encoder, in a subprocess as a user runs it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5"]


def _run(args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "fovealseg_torch.cli.infer",
                           "--cfg", "fovealseg_torch/configs/deform.yaml", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout, env=env)


@pytest.mark.parametrize("batch,micro,frames,chunks", [(2, 0, 2, 2), (4, 2, 6, 4)])
def test_cli_serves_synthetic_batches_on_cpu(tmp_path, batch, micro, frames, chunks):
    out = tmp_path / "masks"
    args = ["--device", "cpu", "--batch", str(batch), "--canvas", "64", "--num-batches", "2",
            "--out", str(out), "--png"]
    if micro:
        args += ["--microbatch", str(micro)]
    proc = _run(args + TINY_OPTS)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # the first chunk is left out of the throughput window
    assert summary["frames"] == frames and summary["fps"] > 0
    assert summary["device"] == "cpu" and summary["microbatch"] == (micro or batch)
    names = sorted(os.listdir(out))
    assert len([n for n in names if n.endswith(".mask.npy")]) == 2 * batch
    assert len([n for n in names if n.endswith(".mask.png")]) == 2 * batch
    m = np.load(out / [n for n in names if n.endswith(".npy")][0])
    assert m.shape == (64, 64) and m.dtype == np.uint8 and m.max() < 51
    assert chunks == 2 * batch // (micro or batch)


def test_cli_defaults_to_the_card():
    proc = _run(["--batch", "1", "--canvas", "64", "--num-batches", "1"] + TINY_OPTS)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-2000:]
    else:
        assert proc.returncode != 0
        assert "device='cpu'" in proc.stderr
