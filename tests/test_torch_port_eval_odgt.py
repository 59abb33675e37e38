"""Port: the multi-scale ODGT evaluation (``fovealseg_torch/cli/eval_odgt.py``)
and the plain ``SegmentationModule`` against the JAX package on the CPU.

The tiny model (``hrnetv2_nodownsp_tiny``, 16x16 task and saliency, radius
5, ``DATASET.num_class 4``, f32) takes the JAX package's PRNGKey(0) weights,
written as the 4-file set by ``save_torch_checkpoint`` (through
``export_torch_state_dict``) and read by the port's CLI with
``--torch-ckpt``. Two ODGT records, 64x64 and 48x72, go through the pyramid
``imgSizes (32, 48)``, ``imgMaxSize 64``, padding 8. The reference is the
JAX package's ``ValDataset`` plus ``DeformSegmentation.infer`` at each level
and the JAX CLI's arithmetic. Tolerances: the averaged scores (logits)
within 1e-5 of their largest magnitude; the labels equal wherever the
JAX scores' top-two margin exceeds 1e-4; the label round trip
(``y_sampled_reverse``) and the warped label bit-equal (the JAX floods on
the TPU's route, :func:`tpu_route`); the result's IoU and
accuracy equal when the labels are. ``--no-deform`` is held against the
JAX ``SegmentationModule.infer`` within 1e-5.

Also here: the payload flood (K2) past 7 rounds on an odd canvas, the route
the TPU takes there (``lax.cond`` to the exact 'payload' kernel).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fovealseg_torch.cli import eval_odgt
from fovealseg_torch.data.odgt import ValDataset
from fovealseg_torch.ops import jfa
from fovealseg_tpu.core import metrics as jmetrics
from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.core.warp import grid_sample as jax_grid_sample
from fovealseg_tpu.data.odgt import ValDataset as JaxValDataset
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.models.segmentation_module import SegmentationModule as JaxSegModule
from fovealseg_tpu.ops.pallas_jfa import nearest_payload_packed_pallas, nearest_payload_pallas
from fovealseg_tpu.train.checkpoint import save_torch_checkpoint
from tests.torch_port_zoo import cut_encoders, no_tensorflow  # noqa: F401

# the TensorBoard writers of the CLIs run here take TensorBoard's stand-in for TensorFlow
pytestmark = pytest.mark.usefixtures("no_tensorflow")

NC = 4
TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=NC, arch_encoder="hrnetv2_nodownsp_tiny")
GAZE = (0.45, 0.55)
PYRAMID = dict(num_class=NC, imgSizes=(32, 48), imgMaxSize=64, padding_constant=8,
               segm_downsampling_rate=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The ODGT set, the JAX weights and their 4-file export."""
    root = tmp_path_factory.mktemp("odgt")
    rng = np.random.default_rng(31)
    recs = []
    for i, (h, w) in enumerate([(64, 64), (48, 72)]):
        img = rng.integers(0, 256, (h // 8, w // 8, 3)).repeat(8, 0).repeat(8, 1)
        img = np.clip(img + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / f"im{i}.png")
        # labels 1..4 in 8x8 blocks (0 = ignore on a few blocks)
        seg = rng.integers(0, NC + 1, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
        Image.fromarray(seg.astype(np.uint8)).save(root / f"seg{i}.png")
        recs.append({"fpath_img": f"im{i}.png", "fpath_segm": f"seg{i}.png",
                     "width": w, "height": h})
    (root / "val.odgt").write_text("\n".join(json.dumps(r) for r in recs))
    jds = JaxValDataset(str(root), str(root / "val.odgt"), list_train="ADE", **PYRAMID)
    jm = JaxDeform(config=JaxConfig(**TINY))
    x0 = jnp.asarray(jds[0]["img_data"][0])
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x0, jnp.asarray([GAZE], jnp.float32))
    v = varied_labels(root, jds, jax.tree.map(np.asarray, v))
    save_torch_checkpoint(str(root / "ckpt"), 1, v["params"], v["batch_stats"], also_last=False)
    return root, jds, jm, v


def varied_labels(root, jds, v):
    """``v`` with a c1 head whose labels vary over the image. The head's
    class logits are one vector per image, and its background logit is that
    vector's last entry times the mask, ``sigmoid(conv_last) - 0.5``. At
    PRNGKey(0) the mask saturates and class 0 wins every pixel, so a label
    taken from the wrong map would pass unseen. Here the class logits are
    the constants (0, -5, -5, 10), and ``conv_last`` is rescaled about the
    median of its output on these records (read through the port on the
    same weights), so the background wins on about half of the pixels."""
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.train.checkpoint import load_torch_checkpoint

    save_torch_checkpoint(str(root / "ckpt0"), 1, v["params"], v["batch_stats"], also_last=False)
    m = DeformSegmentation(DeformConfig(**TINY), dtype=torch.float32, device="cpu")
    load_torch_checkpoint(m, str(root / "ckpt0"), 1, strict=True)
    z = []
    hook = m.decoder.conv_last.register_forward_hook(lambda mod, i, o: z.append(o.flatten()))
    with torch.no_grad():
        for i in range(len(jds)):
            for x in jds[i]["img_data"]:
                m.infer(torch.from_numpy(x), torch.tensor([GAZE]))
    hook.remove()
    z = torch.cat(z).double().numpy()
    lo, med, hi = np.percentile(z, [10, 50, 90])
    alpha = 4.0 / (hi - lo)
    d = v["params"]["decoder"]
    d["conv_last"]["kernel"] = (d["conv_last"]["kernel"] * alpha).astype(np.float32)
    d["conv_last"]["bias"] = np.asarray([-alpha * med], np.float32)
    d["cls_net"]["fc"]["kernel"] = np.zeros_like(d["cls_net"]["fc"]["kernel"])
    d["cls_net"]["fc"]["bias"] = np.asarray([0, -5, -5, 10], np.float32)
    return v


CLI_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
            "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5",
            "DATASET.num_class", str(NC), "DATASET.imgSizes", "(32, 48)",
            "DATASET.imgMaxSize", "64", "DATASET.padding_constant", "8",
            "TPU.compute_dtype", "float32"]


def cli_args(root, *extra, ckpt=True):
    args = ["--cfg", "fovealseg_torch/configs/ade20k.yaml", "--device", "cpu",
            "--gaze", str(GAZE[0]), str(GAZE[1])]
    if ckpt:
        args += ["--torch-ckpt", str(root / "ckpt"), "--torch-epoch", "1"]
    return args + list(extra) + CLI_OPTS + ["DATASET.root_dataset", str(root),
                                            "DATASET.list_val", str(root / "val.odgt")]


def tpu_route(valid, payload, num_iters=None, rounds=None, cls_bits=None, pay_bits=None):
    """The JAX package's flood dispatch as it runs on a TPU ('relpay', K2's
    counterpart), in interpret mode: on the CPU the JAX package takes its lax
    chain, which breaks equidistant ties otherwise (``ROADMAP.md``, known
    differences); the port follows the Pallas kernel."""
    assert cls_bits is None and pay_bits is not None and pay_bits <= 13
    return nearest_payload_packed_pallas(valid, payload, pay_bits, num_iters, interpret=True,
                                         rounds=rounds)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX model as the test runs it: each sub-network under
    ``flax.linen.jit`` (``tests/torch_port_zoo.py::cut_encoders``, which
    cuts nothing at these archs), so that the eager ``infer`` does not
    compile the nets op by op, and the floods on the TPU's route."""
    with cut_encoders(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(junwarp, "_nearest_payload", tpu_route)
        yield


@pytest.fixture(scope="module")
def jax_records(setup, jax_reference):
    """Per record, the JAX CLI's outputs: averaged scores (numpy, f32, its
    order), the last level's task-space scores and their argmax, the warped
    label and the label round trip."""
    root, jds, jm, v = setup
    f = jnp.asarray([GAZE], jnp.float32)
    res = []
    for i in range(len(jds)):
        rec = jds[i]
        seg = np.asarray(rec["seg_label"][0], np.int64)
        y = jnp.asarray(seg[None])
        scores = None
        n = len(rec["img_data"])
        for x in rec["img_data"]:
            out = jm.apply(v, jnp.asarray(x), f, seg_hw=seg.shape, y=y, y_sampled_reverse=True,
                           method=JaxDeform.infer)
            out["y_sampled"] = jax_grid_sample(y.astype(jnp.float32)[..., None], out["grid_y"],
                                               mode="nearest")[..., 0]
            s = np.asarray(out["pred_sampled"], np.float32)
            scores = s / n if scores is None else scores + s / n
        task_scores = np.asarray(out["pred"], np.float32)[0]
        res.append(dict(seg=seg, scores=scores, pred=np.argmax(scores[0], -1),
                        task_scores=task_scores, pred_deformed=np.argmax(task_scores, -1),
                        y_sampled=np.asarray(out["y_sampled"], np.int64)[0],
                        y_sampled_reverse=np.asarray(out["y_sampled_reverse"], np.int64)[0]))
    return res


@pytest.fixture(scope="module")
def port_run(setup):
    """The port's CLI in-process on the JAX export, each record's outputs
    kept through ``on_record``."""
    root = setup[0]
    kept = []
    result = eval_odgt.main(cli_args(root, "VAL.y_sampled_reverse", "True",
                                     "DIR", str(root / "run")),
                            on_record=lambda i, rec, res: kept.append(
                                {k: t.numpy() for k, t in res.items()}))
    return result, kept


def test_readers_give_the_same_records(setup):
    root, jds = setup[0], setup[1]
    ds = ValDataset(str(root), str(root / "val.odgt"), list_train="ADE", **PYRAMID)
    for i in range(len(jds)):
        a, b = ds[i], jds[i]
        assert [x.shape for x in a["img_data"]] == [x.shape for x in b["img_data"]]
        for x, y in zip(a["img_data"], b["img_data"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a["seg_label"], b["seg_label"])
    # the pyramid of the 48x72 record: short side 32 -> 32x48, then capped by 64
    assert [x.shape[1:3] for x in ds[1]["img_data"]] == [(32, 48), (48, 64)]


def decided(scores):
    """Where the top-two margin of ``scores`` [..., C] exceeds 1e-4."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 1e-4


def test_record_scores_labels_and_round_trip(jax_records, port_run):
    """The averaged scores and their labels, and the last level's
    task-space labels (``pred_deformed``, held where JAX's task-space
    scores decide them)."""
    _, kept = port_run
    assert len(kept) == len(jax_records) == 2
    for i, (got, ref) in enumerate(zip(kept, jax_records)):
        np.testing.assert_array_equal(got["seg"], ref["seg"])
        assert got["scores"].dtype == np.float32 and got["scores"].shape == ref["scores"].shape
        # the scores are logits (up to ~20 here): within 1e-5 of the map's largest magnitude
        scale = np.abs(ref["scores"]).max()
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-5 * scale)
        full = decided(ref["scores"][0])
        assert full.mean() > 0.5, i
        assert len(np.unique(ref["pred"])) >= 2 and len(np.unique(ref["pred_deformed"])) >= 2
        np.testing.assert_array_equal(got["pred"][full], ref["pred"][full])
        assert got["pred_deformed"].shape == ref["pred_deformed"].shape == (16, 16)
        task = decided(ref["task_scores"])
        assert task.mean() > 0.5, i
        np.testing.assert_array_equal(got["pred_deformed"][task], ref["pred_deformed"][task])
        np.testing.assert_array_equal(got["y_sampled"], ref["y_sampled"])
        np.testing.assert_array_equal(got["y_sampled_reverse"], ref["y_sampled_reverse"])


def jax_cli_result(recs, nc=NC, deform=True):
    """The JAX CLI's result arithmetic on per-record labels (``ignore_index``
    -1, the default)."""
    acc_m = acc_def = acc_rev = 0.0
    sums = {}

    def add(k, v):
        sums[k] = v if k not in sums else sums[k] + v

    for r in recs:
        seg = jnp.asarray(r["seg"])
        acc_m += float(jmetrics.accuracy(jnp.asarray(r["pred"]), seg)[0])
        for k, v in zip(("i", "u"), jmetrics.intersection_and_union(jnp.asarray(r["pred"]), seg,
                                                                     nc)):
            add(k, v)
        if deform:
            acc_def += float(jmetrics.accuracy(jnp.asarray(r["pred_deformed"]),
                                               jnp.asarray(r["y_sampled"]))[0])
            for k, v in zip(("id", "ud"), jmetrics.intersection_and_union(
                    jnp.asarray(r["pred_deformed"]), jnp.asarray(r["y_sampled"]), nc)):
                add(k, v)
            yr = jnp.asarray(r["y_sampled_reverse"])
            acc_rev += float(jmetrics.accuracy(yr, seg)[0])
            for k, v in zip(("ir", "ur"), jmetrics.intersection_and_union(yr, seg, nc)):
                add(k, v)

    def miou(i, u):
        i, u = np.asarray(i, np.float64), np.asarray(u, np.float64)
        return float((i[u > 0] / u[u > 0]).mean())

    n = len(recs)
    out = {"mean_iou": miou(sums["i"], sums["u"]), "pixel_acc": acc_m / n, "num_samples": n,
           "scales": [32, 48]}
    if deform:
        out.update(mean_iou_deformed=miou(sums["id"], sums["ud"]), pixel_acc_deformed=acc_def / n,
                   y_reverse_iou=miou(sums["ir"], sums["ur"]), y_reverse_acc=acc_rev / n)
    return out


def test_cli_result_equals_jax_arithmetic(jax_records, port_run):
    """With the JAX labels (``pred`` and ``pred_deformed``) where JAX's
    scores decide them and the port's elsewhere, the JAX CLI's arithmetic
    gives the port's result exactly; where every label agrees, the JAX
    labels alone give it. The round-trip and warped metrics take labels that
    are bit-equal."""
    result, kept = port_run
    recs = []
    for g, r in zip(kept, jax_records):
        full, task = decided(r["scores"][0]), decided(r["task_scores"])
        recs.append(dict(r, pred=np.where(full, r["pred"], g["pred"]),
                         pred_deformed=np.where(task, r["pred_deformed"], g["pred_deformed"])))
    want = jax_cli_result(recs)
    assert set(result) == set(want)
    for k, v in want.items():
        assert result[k] == v, k
    if all(np.array_equal(g[k], r[k]) for g, r in zip(kept, jax_records)
           for k in ("pred", "pred_deformed")):
        assert jax_cli_result(jax_records) == result
    assert 0.0 <= result["mean_iou"] <= 1.0 and result["y_reverse_acc"] > 0.5


def test_no_deform_against_jax_segmentation_module(setup, jax_reference):
    root, jds, _, v = setup
    sm = JaxSegModule(config=JaxConfig(**TINY))
    sv = {"params": {k: v["params"][k] for k in ("encoder", "decoder")},
          "batch_stats": {k: v["batch_stats"][k] for k in ("encoder", "decoder")
                          if k in v["batch_stats"]}}

    def infer(sv, x, seg_hw):
        return sm.apply(sv, x, seg_hw=seg_hw, method=JaxSegModule.infer)
    kept = []
    result = eval_odgt.main(cli_args(root, "--no-deform", "DIR", str(root / "nd")),
                            on_record=lambda i, rec, res: kept.append(res["scores"].numpy()))
    assert "mean_iou_deformed" not in result and result["num_samples"] == 2
    for i in range(len(jds)):
        rec = jds[i]
        seg_hw = rec["seg_label"].shape[1:]
        ref = None
        for x in rec["img_data"]:
            s = np.asarray(infer(sv, jnp.asarray(x), seg_hw=seg_hw), np.float32)
            ref = s / 2 if ref is None else ref + s / 2
        np.testing.assert_allclose(kept[i], ref, rtol=0, atol=1e-5)


def test_cli_outputs_and_precedence(setup, tmp_path, caplog):
    """``VAL.visualize``, ``VAL.report_per_img_iou``, ``--object-info`` and
    ``--num-samples``; random weights warn; a missing ``MODEL.weights_*``
    file and ``VAL.ensemble`` raise."""
    root = setup[0]
    info = tmp_path / "info.csv"
    info.write_text("Idx,Ratio,Train,Val,Stuff,Name\n"
                    + "".join(f"{i + 1},0.1,1,1,0,thing{i};x\n" for i in range(NC)))
    with caplog.at_level("INFO"):
        r = eval_odgt.main(cli_args(root, "--num-samples", "1", "--object-info", str(info),
                                    "VAL.visualize", "True", "VAL.report_per_img_iou", "True",
                                    "DIR", str(tmp_path / "run"), ckpt=False))
    assert r["num_samples"] == 1
    assert "RANDOMLY INITIALIZED" in caplog.text and "thing0" in caplog.text
    assert (tmp_path / "run" / "result" / "im0.png").exists()
    rows = (tmp_path / "run" / "image_IoUs_list.csv").read_text().splitlines()
    assert rows[0].startswith("idx,image_name,image_mIoU") and len(rows) == 2
    assert Image.open(tmp_path / "run" / "result" / "im0.png").size == (64 * 3, 64)
    with pytest.raises(FileNotFoundError, match="nope.pth"):
        eval_odgt.main(cli_args(root, "MODEL.weights_encoder", str(tmp_path / "nope.pth"),
                                ckpt=False))
    with pytest.raises(NotImplementedError):
        eval_odgt.main(cli_args(root, "VAL.ensemble", "True"))


@pytest.mark.parametrize("rounds", [8, 9])
def test_payload_packed_past_seven_rounds(rounds):
    """K2's plain version with the round count given as a tensor (the
    device scalar of ``jfa_rounds_from_grid``, which stays on K2 in the
    port) on a 130x197 canvas (full rounds 8) against the TPU's route
    there: 'relpay' hands counts above 7 to the exact 'payload' kernel,
    run in interpret mode."""
    rng = np.random.default_rng(rounds)
    valid = rng.uniform(size=(1, 130, 197)) > 0.985
    pay = rng.integers(0, 2**13, (1, 130, 197)).astype(np.int32)
    assert jfa.full_rounds(130, 197) == 8
    got = jfa.nearest_payload_packed_plain(torch.from_numpy(valid), torch.from_numpy(pay), 13,
                                           torch.tensor(rounds, dtype=torch.int32))
    r = jnp.int32(rounds)
    ref = np.asarray(nearest_payload_pallas(jnp.asarray(valid), jnp.asarray(pay), interpret=True,
                                            rounds=r))
    np.testing.assert_array_equal(got.numpy(), ref)
    packed = np.asarray(nearest_payload_packed_pallas(jnp.asarray(valid), jnp.asarray(pay), 13,
                                                      interpret=True, rounds=r))
    np.testing.assert_array_equal(packed, ref)
