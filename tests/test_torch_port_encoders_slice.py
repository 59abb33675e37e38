"""Port: the slice with the SegFormer and DeepLab encoders and the ResNetZoom
saliency nets, as a whole, against the JAX package on the CPU.

``DeformSegmentation`` at the tiny size of ``test_torch_port_slice.py`` (64x64
canvas, 16x16 task and saliency, radius 5, 51 classes, f32, batch 2) with
each new encoder at a cut depth, or the tiny HRNet with a ResNetZoom
saliency (``tests/torch_port_zoo.py``: ``cut_encoders`` patches
``build_encoder`` in both packages' builders inside the tests). The same
seeded weights go to both sides through the JAX package's 4-file torch
export. The train step of each new encoder is in
``test_torch_port_{segformer,deeplab}.py``.

Tolerances, as the HRNet slice's (``test_torch_port_slice.py``,
``test_torch_port_scoremap.py``): the saliency and grid to 1e-5, the warped
image to 1e-4 and the logits to 1e-4 of their largest magnitude (2e-4 with
``resnet18_stride1``: its saliency comes out of a ResNet and moves by 9e-7,
the grid by 3e-6, the warped noise frame by 5.7e-5 and the logits by
1.2e-4, measured), the served labels on >= 99.5% of pixels, the score map
to the logits' tolerance on the pixels whose jump-flood winner the JAX package's CPU lax
chain picks alike (it breaks border ties its own way; >= 95% of pixels).
The eval CLI: the labels on >= 95% of pixels (the checkpoint's background
head, moved so that the labels split each frame, leaves many task pixels
near the decision boundary of the synthetic frames: measured 97.4% with
SegFormer) and the metrics within the bounds the disagreement allows
(``test_torch_port_eval.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.core.grid import inverse_grid_index as jax_inverse_grid_index
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.ops.pallas_jfa import nearest_payload_packed_pallas
from fovealseg_tpu.train.checkpoint import save_torch_checkpoint
from fovealseg_torch.configs import get_default_cfg
from fovealseg_torch.core import metrics
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import (
    SUBMODULE_OF_FILE,
    from_jax_variables,
    load_torch_checkpoint,
    load_torch_weight_files,
)
from tests.torch_port_zoo import (
    SLICE_MODELS,
    cut_encoders,
    rel_err,
    slice_config,
    slice_data,
    slice_variables,
)

SEG_HW = (64, 64)
LOGIT_TOL = {"segformer": 1e-4, "deeplab": 1e-4, "resnet18_stride1": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """2 torch threads; the cut encoders in both builders."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with cut_encoders():
        yield
    torch.set_num_threads(prev)


_VARS = {}


def _variables(name):
    if name not in _VARS:
        _VARS[name] = slice_variables(name)
    return _VARS[name]


def _port(name):
    v = _variables(name)
    model = DeformSegmentation(DeformConfig(**slice_config(name)), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    return model


@pytest.mark.parametrize("name", SLICE_MODELS)
def test_four_file_export_loads_strict(name, tmp_path):
    """The JAX package's 4-file export of the model loads into the port
    strictly, through both loaders, to the values ``from_jax_variables``
    gives (bit for bit)."""
    v = _variables(name)
    save_torch_checkpoint(str(tmp_path), 2, v["params"], v["batch_stats"], also_last=False)
    want = from_jax_variables(v["params"], v["batch_stats"])
    model = DeformSegmentation(DeformConfig(**slice_config(name)), device="cpu")
    load_torch_checkpoint(model, str(tmp_path), 2)
    for k, t in model.state_dict().items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)
    other = DeformSegmentation(DeformConfig(**slice_config(name)), device="cpu")
    files = {kind: str(tmp_path / f"{kind}_epoch_2.pth") for kind in SUBMODULE_OF_FILE}
    assert sorted(load_torch_weight_files(other, files)) == sorted(SUBMODULE_OF_FILE)
    if SLICE_MODELS[name][2].endswith("_nonsyn"):
        assert not any("running" in k for k in other.localization.state_dict())


def _agree(grid):
    """Pixels whose score-map flood winner the port (the Pallas kernel's
    semantics) and the JAX package's CPU lax chain pick alike."""
    task_idx, valid = jax_inverse_grid_index(jnp.asarray(grid), SEG_HW)
    rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(grid), SEG_HW)
    ours = nearest_payload_packed_pallas(valid, task_idx, 8, interpret=True, rounds=rounds)
    return np.asarray(ours) == np.asarray(junwarp.nearest_seed_payload(valid, task_idx))


@pytest.mark.parametrize("name", LOGIT_TOL)
def test_infer_matches_jax(name):
    """``infer`` with argmax labels and with score maps."""
    x, f = slice_data()
    v = _variables(name)
    jm = JaxDeform(config=JaxConfig(**slice_config(name)))
    model = _port(name)
    for argmax in (True, False):
        ref = jax.tree.map(np.asarray, jm.apply(v, jnp.asarray(x), jnp.asarray(f),
                                                argmax_labels=argmax, method=JaxDeform.infer))
        got = {k: t.numpy() for k, t in model.infer(torch.from_numpy(x), torch.from_numpy(f),
                                                    argmax_labels=argmax).items()}
        for k in ("xs", "grid"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
        assert rel_err(got["x_sampled"], ref["x_sampled"]) <= 1e-4
        assert rel_err(got["pred"], ref["pred"]) <= LOGIT_TOL[name]
        if argmax:
            assert got["pred_label"].dtype == np.int32
            assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.995
        else:
            same = _agree(ref["grid"])
            assert same.mean() >= 0.95
            scale = np.abs(ref["pred_sampled"]).max()
            assert got["pred_sampled"].shape == (2, 64, 64, 51)
            assert (np.abs(got["pred_sampled"] - ref["pred_sampled"])[same].max()
                    <= LOGIT_TOL[name] * scale)


EVAL_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.gaussian_radius", "5", "VAL.batch_size", "2"]


@pytest.mark.parametrize("name", ["segformer", "deeplab"])
def test_eval_cli_batch_matches_jax(name, tmp_path):
    """One b2 batch of the port's eval CLI on a 4-file checkpoint written by
    the JAX package, against the JAX package's ``infer`` on the same frames
    (``make_batch``'s draws, bit-equal in both packages) and the JAX CLI's
    result for the JAX labels (the port's ``accumulate`` reproduces that
    exactly: ``test_torch_port_eval.py``). The labels agree on >= 95% of
    pixels; the pixel accuracy is within the disagreeing share, the mean IoU
    within mean(2d / U) over the classes present (d disagreeing pixels)."""
    from fovealseg_tpu.data.synthetic import make_batch
    from fovealseg_torch.cli import eval as port_cli

    arch, fc_dim, _ = SLICE_MODELS[name]
    v = _variables(name)
    save_torch_checkpoint(str(tmp_path / "ckpt"), 1, v["params"], v["batch_stats"],
                          also_last=False)
    seen = []
    pres = port_cli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu",
                          "--num-batches", "1", "--canvas", "64", "--torch-ckpt",
                          str(tmp_path / "ckpt"), "--torch-epoch", "1", *EVAL_OPTS,
                          "MODEL.arch_encoder", arch, "MODEL.fc_dim", str(fc_dim),
                          "DIR", str(tmp_path / "port")],
                         on_batch=lambda out, pred, gt, acc: seen.append((pred, gt)))
    (pred, gt), = seen
    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(EVAL_OPTS + ["DIR", str(tmp_path / "replay")])
    rng = np.random.default_rng(cfg.TRAIN.seed)
    make_batch(rng, 2, canvas=64)  # the CLIs' discarded draw
    batch = make_batch(rng, 2, canvas=64)
    y, cls = batch["seg_label"], batch["cls_label"].reshape(-1)
    np.testing.assert_array_equal(y * cls[:, None, None] + (1 - y) * 50, gt.numpy())
    jm = JaxDeform(config=JaxConfig(**slice_config(name)))
    jp = np.asarray(jm.apply(v, jnp.asarray(batch["img_data"]), jnp.asarray(batch["focus_point"]),
                             argmax_labels=True, method=JaxDeform.infer)["pred_label"])
    jres = port_cli.accumulate([(torch.from_numpy(jp.astype(np.int64)), gt.long(), None)], cfg)
    pp = pred.numpy()
    d = int((jp != pp).sum())
    assert d / pp.size <= 0.05
    assert len(np.unique(pp)) > 1  # the labels split the frames
    assert set(pres) == set(jres) and pres["num_batches"] == 1
    assert abs(pres["pixel_acc"] - jres["pixel_acc"]) <= d / pp.size + 1e-12
    union = metrics.intersection_and_union(pred.long(), gt.long(), 51)[1].numpy()
    u = np.maximum(union - d, 1)
    bound = float(np.mean(np.minimum(2.0 * d / u, 1.0)[union > 0]))
    assert abs(pres["mean_iou"] - jres["mean_iou"]) <= bound + 1e-12
