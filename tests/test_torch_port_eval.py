"""Port: the eval slice against the JAX package on the CPU.

The same numpy inputs from a seed go through each JAX function and its port:
the metrics, the synthetic data, ``resize_nearest``, the edge targets, the
eval branches of ``DeformSegmentation`` (the uniform baselines,
``VAL.F_Xlr_low_scale``, ``MODEL.gt_gradient`` with labels), the weight
loaders, and the eval CLI end to end against ``cli/eval.py``. The tolerance
of each comparison is stated beside it.

``DeformSegmentation`` runs at the tiny size of ``test_torch_port_slice.py``
(``hrnetv2_nodownsp_tiny``, 64x64 canvas, 16x16 task and saliency, radius 5,
51 classes, f32, the same PRNGKey(0) weights on both sides) and is held to
that file's tolerances: the geometry to 1e-5, the logits and the maps made
from them to 1e-4 relative, labels on >= 99.5% of pixels.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from fovealseg_tpu.core import edges as jedges
from fovealseg_tpu.core import metrics as jmetrics
from fovealseg_tpu.core.interpolate import resize_nearest as jax_resize_nearest
from fovealseg_tpu.data.synthetic import make_batch as jax_make_batch
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_torch.configs import audit_dead_keys, get_default_cfg
from fovealseg_torch.core import edges, metrics
from fovealseg_torch.core.interpolate import resize_nearest
from fovealseg_torch.data import synthetic
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import from_jax_variables, load_torch_weight_files
from tests.torch_port_zoo import no_tensorflow  # noqa: F401

# the TensorBoard writers of the CLIs run here take TensorBoard's stand-in for TensorFlow
pytestmark = pytest.mark.usefixtures("no_tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
TINY_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5"]
EVAL_OPTS = ["VAL.batch_size", "2", "VAL.y_sampled_reverse", "True", "VAL.dice", "True",
             "VAL.hd95", "True", "VAL.trimap", "True", "TPU.compile_cache_dir", ""]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- metrics

@pytest.fixture(scope="module")
def metric_inputs():
    """51 classes, 1/8 of the pixels ignored (-1), predictions right on ~1/3."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 51, (3, 40, 48)).astype(np.int32)
    labels[rng.uniform(size=labels.shape) < 0.125] = -1
    logits = rng.normal(size=(3, 40, 48, 51)).astype(np.float32)
    right = (rng.uniform(size=labels.shape) < 0.35) & (labels >= 0)
    logits[right, np.maximum(labels, 0)[right]] += 10.0
    preds = np.argmax(logits, -1).astype(np.int32)
    return labels, logits, preds


@pytest.mark.parametrize("name", ["pixel_acc", "fg_bin_pixel_acc", "fbg_cls_pixel_acc",
                                  "fbg_bin_pixel_acc"])
def test_pixel_acc_family(metric_inputs, name):
    """Float results within 1e-6."""
    labels, logits, _ = metric_inputs
    got = getattr(metrics, name)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = getattr(jmetrics, name)(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-6


def test_accuracy(metric_inputs):
    """The valid count exactly, the accuracy within 1e-6."""
    labels, _, preds = metric_inputs
    acc, n = metrics.accuracy(torch.from_numpy(preds), torch.from_numpy(labels))
    jacc, jn = jmetrics.accuracy(jnp.asarray(preds), jnp.asarray(labels))
    assert int(n) == int(jn)
    assert abs(float(acc) - float(jacc)) <= 1e-6


def test_intersection_and_union(metric_inputs):
    """Integer histograms, exactly."""
    labels, _, preds = metric_inputs
    inter, union = metrics.intersection_and_union(torch.from_numpy(preds),
                                                  torch.from_numpy(labels), 51)
    jinter, junion = jmetrics.intersection_and_union(jnp.asarray(preds), jnp.asarray(labels), 51)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(jinter))
    np.testing.assert_array_equal(union.numpy(), np.asarray(junion))
    assert inter.sum() > 0 and union.shape == (51,)


def test_intersection_and_union_negative_predictions(metric_inputs):
    """A -1 predicted on a labelled pixel (the label round trip carries the
    ignore id) counts as class 0, as ``jnp.bincount`` clips it: exactly."""
    labels, _, preds = metric_inputs
    preds = np.where(np.random.default_rng(2).uniform(size=preds.shape) < 0.1, -1, preds)
    inter, union = metrics.intersection_and_union(torch.from_numpy(preds),
                                                  torch.from_numpy(labels), 51)
    jinter, junion = jmetrics.intersection_and_union(jnp.asarray(preds), jnp.asarray(labels), 51)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(jinter))
    np.testing.assert_array_equal(union.numpy(), np.asarray(junion))
    assert ((preds == -1) & (labels >= 0)).any()


def test_confusion_matrix(metric_inputs):
    """Integer counts, exactly."""
    labels, _, preds = metric_inputs
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 51)
    ref = jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 51)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) == int((labels >= 0).sum())


@pytest.mark.parametrize("width", [1, 2, 5])
def test_trimap(metric_inputs, width):
    """The host metrics are the same numpy code: equal exactly."""
    labels, _, preds = metric_inputs
    np.testing.assert_array_equal(metrics.trimap_band(labels[0], width),
                                  jmetrics.trimap_band(labels[0], width))
    assert metrics.trimap_accuracy(preds[1], labels[1], width) == \
        jmetrics.trimap_accuracy(preds[1], labels[1], width)


def test_dice_and_hd95(metric_inputs):
    labels, _, preds = metric_inputs
    for b in range(labels.shape[0]):
        p, g = preds[b] < 10, labels[b] < 10
        assert metrics.binary_dice(p, g) == jmetrics.binary_dice(p, g)
        assert metrics.hd95(p, g) == jmetrics.hd95(p, g)
    empty = np.zeros((8, 8), bool)
    assert math.isnan(metrics.hd95(empty, labels[0, :8, :8] < 10))


# ---------------------------------------------------------------- data, resize

@pytest.mark.parametrize("seed,batch,canvas", [(304, 2, 64), (0, 3, 96), (11, 1, 640)])
def test_make_batch_bit_equal(seed, batch, canvas):
    """The same generator gives the same arrays, bit for bit, and leaves the
    generator in the same state."""
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = synthetic.make_batch(rng_p, batch, canvas=canvas)
    ref = jax_make_batch(rng_j, batch, canvas=canvas)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert rng_p.random() == rng_j.random()


@pytest.mark.parametrize("in_hw,out_hw", [((16, 16), (64, 64)), ((64, 64), (16, 16)),
                                          ((10, 14), (33, 21)), ((33, 21), (10, 14)),
                                          ((16, 20), (16, 60))])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_resize_nearest_bit_equal(in_hw, out_hw, dtype):
    rng = np.random.default_rng(3)
    x = (rng.uniform(0, 50, (2, *in_hw, 3))).astype(dtype)
    got = resize_nearest(torch.from_numpy(x), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_resize_nearest(jnp.asarray(x),
                                                                              out_hw)))
    assert got.shape == (2, *out_hw, 3)


# ---------------------------------------------------------------- edges

@pytest.mark.parametrize("radius", [0.5, 1.0, 2.5])
def test_gaussian_blur(radius):
    """Within 1e-6: two VALID convolutions in f32 whose sums may be ordered
    differently."""
    x = np.random.default_rng(4).uniform(0, 1, (2, 20, 24, 1)).astype(np.float32)
    got = edges.gaussian_blur(torch.from_numpy(x), radius).numpy()
    ref = np.asarray(jedges.gaussian_blur(jnp.asarray(x), radius))
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_pil_find_edges_bit_equal():
    """Bit-equal on the same input. The uint8 quantisation rounds half to
    even on both sides; the input holds 64 exact .5 ties (x * 255 = k + 0.5
    in f32), which agree too."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 24, 32, 1)).astype(np.float32)
    k = rng.integers(0, 255, 64)
    ties = (k + 0.5).astype(np.float32) / np.float32(255.0)
    exact = (ties * np.float32(255.0)) == (k + 0.5).astype(np.float32)
    x.reshape(-1)[rng.choice(x.size, 64, replace=False)] = ties
    n_ties = int(((x * np.float32(255.0)) % 1 == 0.5).sum())
    assert n_ties == int(exact.sum()) > 0
    got = edges.pil_find_edges(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jedges.pil_find_edges(jnp.asarray(x))))


def test_pil_find_edges_against_pil():
    """Against PIL itself, as tests/test_edges.py holds the JAX package."""
    u8 = np.random.default_rng(6).integers(0, 256, (2, 16, 20)).astype(np.uint8)
    ours = edges.pil_find_edges(torch.from_numpy(u8 / 255.0).float()[..., None]).numpy()[..., 0]
    for b in range(2):
        ref = np.asarray(Image.fromarray(u8[b], "L").filter(ImageFilter.FIND_EDGES))
        np.testing.assert_array_equal(np.round(ours[b] * 255).astype(np.uint8), ref)


def _ellipse_labels(batch=2, hw=64, seed=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = np.full((batch, hw, hw), 50, np.int32)
    for b in range(batch):
        cy, cx = rng.uniform(hw / 4, 3 * hw / 4, 2)
        ry, rx = rng.uniform(hw / 8, hw / 3, 2)
        out[b][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = rng.integers(0, 50)
        out[b, : hw // 8, : hw // 8] = 3
    return out


@pytest.mark.parametrize("softmax,zero_bound", [(False, 0), (True, 0), (False, 2), (True, 1)])
def test_edge_target_pil_style(softmax, zero_bound):
    """Within 1e-6 on the labels' edge map: the blur differs by ~1e-7, and
    on these labels no pixel sits within that of a uint8 step, so the
    quantised edges are equal and only the resizes' last bits move."""
    y = _ellipse_labels()
    args = ((16, 16), (20, 20), 1.0)
    got = edges.edge_target_pil_style(torch.from_numpy(y), *args, softmax=softmax,
                                      zero_bound=zero_bound).numpy()
    ref = np.asarray(jedges.edge_target_pil_style(jnp.asarray(y), *args, softmax=softmax,
                                                  zero_bound=zero_bound))
    assert got.shape == ref.shape == (2, 20, 20, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if zero_bound:
        assert (got[:, :zero_bound] == 0).all() and (got[:, :, -zero_bound:] == 0).all()
    assert got.max() > 0


# ---------------------------------------------------------------- DeformSegmentation

@pytest.fixture(scope="module")
def jax_weights():
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    jm = JaxDeform(config=JaxConfig(**TINY))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(f))
    return x, f, _ellipse_labels(), v


def _pair(v, **over):
    jm = JaxDeform(config=JaxConfig(**TINY, **over))
    model = DeformSegmentation(DeformConfig(**TINY, **over), device="cpu")
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                                             jax.tree.map(np.asarray, v["batch_stats"])),
                          strict=True)
    return jm, model


def _both_infer(jax_weights, over, **kw):
    x, f, y, v = jax_weights
    jm, model = _pair(v, **over)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(f), y=jnp.asarray(y), method=JaxDeform.infer,
                   **kw)
    got = model.infer(torch.from_numpy(x), torch.from_numpy(f), y=torch.from_numpy(y), **kw)
    return ({k: np.asarray(t) for k, t in ref.items()}, {k: t.numpy() for k, t in got.items()})


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0)


@pytest.mark.parametrize("uniform", ["BI", "nearest"])
def test_uniform_infer(jax_weights, uniform):
    """Both round trips on. The uniform saliency is the same constant on both
    sides; 'BI' bypasses the warp (x_sampled a plain bilinear resize), and
    both invert by a plain resize. The label round trip of 'BI' (floor of a
    bilinear resize, then nearest) is equal exactly; that of 'nearest' runs
    the jump flood, whose border ties follow the Pallas kernel here and the
    lax chain in the JAX package: >= 95% of pixels, as in
    test_torch_port_scoremap.py."""
    ref, got = _both_infer(jax_weights, {"uniform_sample": uniform}, argmax_labels=True,
                           y_sampled_reverse=True, x_sampled_reverse=True)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["xs"], ref["xs"])
    np.testing.assert_allclose(got["grid"], ref["grid"], rtol=0, atol=1e-5)
    for k in ("x_sampled", "pred", "pred_sampled"):
        assert got[k].shape == ref[k].shape and _rel(got[k], ref[k]) <= 1e-4, k
    assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.995
    if uniform == "BI":
        np.testing.assert_array_equal(got["y_sampled"], ref["y_sampled"])
        np.testing.assert_array_equal(got["y_sampled_reverse"], ref["y_sampled_reverse"])
        assert _rel(got["x_sampled_reverse"], ref["x_sampled_reverse"]) <= 1e-4
    else:
        np.testing.assert_array_equal(got["y_sampled"], ref["y_sampled"])
        assert (got["y_sampled_reverse"] == ref["y_sampled_reverse"]).mean() >= 0.95


@pytest.mark.parametrize("uniform", ["BI", "nearest"])
def test_uniform_forward(jax_weights, uniform):
    x, f, _, v = jax_weights
    jm, model = _pair(v, uniform_sample=uniform)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(f), train=False)
    got = model(torch.from_numpy(x), torch.from_numpy(f))
    assert set(got) == set(ref)
    for k in ("xs", "xs_our", "grid", "grid_y", "x_sampled", "pred"):
        assert _rel(got[k].numpy(), np.asarray(ref[k])) <= 1e-4, k


def test_f_xlr_low_scale(jax_weights):
    """VAL.F_Xlr_low_scale=2: an 8x8 saliency input, upsampled to the 16x16
    grid; the geometry to 1e-5 and labels on >= 99.5% of pixels."""
    ref, got = _both_infer(jax_weights, {"f_xlr_low_scale": 2}, argmax_labels=True)
    _, plain = _both_infer(jax_weights, {}, argmax_labels=True)
    np.testing.assert_allclose(got["xs"], ref["xs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grid"], ref["grid"], rtol=0, atol=1e-5)
    assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.995
    assert not np.array_equal(got["xs"], plain["xs"])  # the branch changes the saliency


@pytest.mark.parametrize("case", ["fix", "fix_ignore", "detach_zero_bound"])
def test_gt_gradient_with_labels(jax_weights, case):
    """MODEL.gt_gradient with labels. 'fix': the label-edge sampler replaces
    the saliency (deform_zero_bound 1, as deform.yaml sets); 'fix_ignore':
    the same with MODEL.ignore_gt_labels mapping 3 and 50 to 0;
    'detach_zero_bound': no fix, the predicted saliency masked 2 cells from
    the border. The override to 1e-6 (test_edge_target_pil_style), the grid
    to 1e-5, labels on >= 99.5% of pixels."""
    over = {"fix": dict(fix_gt_gradient=True, deform_zero_bound=1),
            "fix_ignore": dict(fix_gt_gradient=True, deform_zero_bound=1,
                               ignore_gt_labels=(3, 50)),
            "detach_zero_bound": dict(deform_zero_bound=2)}[case]
    ref, got = _both_infer(jax_weights, dict(gt_gradient=True, **over), argmax_labels=True)
    np.testing.assert_allclose(got["xs"], ref["xs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["grid"], ref["grid"], rtol=0, atol=1e-5)
    assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.995
    b = over["deform_zero_bound"]
    assert (got["xs"][:, :b] == 0).all() and (got["xs"][:, -b:] == 0).all()
    if case != "detach_zero_bound":
        assert got["xs"].max() > 0.1  # an edge map, not a softmax saliency


def test_deform_config_from_cfg():
    """The gt-gradient fields map as the JAX package maps them."""
    from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg

    cfgs = (get_default_cfg(), jax_default_cfg())
    for cfg in cfgs:
        cfg.merge_from_file(os.path.join(REPO, "fovealseg_torch/configs/deform.yaml"))
        cfg.merge_from_list(["MODEL.fix_gt_gradient", "True", "MODEL.ignore_gt_labels", "[3, 7]",
                             "MODEL.gt_grad_gaussian_blur_r", "2", "TRAIN.deform_zero_bound_factor",
                             "3", "VAL.F_Xlr_low_scale", "2"])
    port, ref = DeformConfig.from_cfg(cfgs[0]), JaxConfig.from_cfg(cfgs[1])
    for field in ("fix_gt_gradient", "ignore_gt_labels", "gt_grad_blur_r", "deform_zero_bound",
                  "f_xlr_low_scale", "uniform_sample", "gt_gradient"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.deform_zero_bound == 3 and port.ignore_gt_labels == (3, 7)


def test_audit_dead_keys():
    from fovealseg_tpu.configs import audit_dead_keys as jax_audit
    from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg

    opts = ["TRAIN.workers", "4", "VAL.F_Xlr_low_scale", "2", "MODEL.deconv", "True"]
    port, ref = get_default_cfg(), jax_default_cfg()
    port.merge_from_list(opts)
    ref.merge_from_list(opts)
    assert audit_dead_keys(port) == jax_audit(ref)
    assert audit_dead_keys(get_default_cfg()) == []


def test_load_torch_weight_files(tmp_path, jax_weights, caplog):
    """Empty entries are skipped, a missing file raises; a file's keys that
    the model lacks are skipped and logged, as the JAX package's import
    skips them (``strict=True`` raises for them)."""
    _, _, _, v = jax_weights
    sd = from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                            jax.tree.map(np.asarray, v["batch_stats"]))
    enc = {k[len("encoder."):]: t for k, t in sd.items() if k.startswith("encoder.")}
    torch.save(enc, tmp_path / "enc.pth")
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    loaded = load_torch_weight_files(model, {"encoder": str(tmp_path / "enc.pth"),
                                             "decoder": "", "saliency": "", "compress": ""})
    assert loaded == ["encoder"]
    for k, t in model.encoder.state_dict().items():
        torch.testing.assert_close(t, enc[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_torch_weight_files(model, {"decoder": str(tmp_path / "missing.pth")})
    torch.save({"bogus": torch.zeros(1)}, tmp_path / "bad.pth")
    before = {k: t.clone() for k, t in model.decoder.state_dict().items()}
    with caplog.at_level("WARNING", logger="fovealseg"):
        assert load_torch_weight_files(model, {"decoder": str(tmp_path / "bad.pth")}) == ["decoder"]
    assert "bogus" in caplog.text
    for k, t in model.decoder.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        load_torch_weight_files(model, {"decoder": str(tmp_path / "bad.pth")}, strict=True)


# ---------------------------------------------------------------- the CLI

def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_cli_eval", os.path.join(REPO, "cli",
                                                                               "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _eval_cfg(out_dir):
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "fovealseg_torch/configs/deform.yaml"))
    cfg.merge_from_list(TINY_OPTS + EVAL_OPTS + ["DIR", str(out_dir)])
    return cfg


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, jax_weights):
    """Both CLIs on one 4-file checkpoint written by the JAX package, 2
    batches of 2 on a 64x64 canvas; each CLI's frames and its labels are
    recorded on the way to its metrics. The checkpoint is the JAX init with
    the decoder's background head moved (the mask conv's bias +15, which
    centres its pre-activation at this init, and the background class's
    bias +100), so that background and foreground split each frame and the
    metrics are not all zero."""
    from fovealseg_tpu.core import metrics as jax_metrics_module
    from fovealseg_tpu.data import synthetic as jax_synthetic
    from fovealseg_tpu.train.checkpoint import save_torch_checkpoint
    from fovealseg_torch.cli import eval as port_cli

    _, _, _, v = jax_weights
    root = tmp_path_factory.mktemp("eval_cli")
    params = jax.tree.map(np.array, v["params"])
    params["decoder"]["conv_last"]["bias"] += 15.0
    params["decoder"]["cls_net"]["fc"]["bias"][50] += 100.0
    save_torch_checkpoint(str(root / "ckpt"), 1, params,
                          jax.tree.map(np.asarray, v["batch_stats"]), also_last=False)
    common = ["--num-batches", "2", "--canvas", "64", "--torch-ckpt", str(root / "ckpt"),
              "--torch-epoch", "1"]
    rec = {"jax_frames": [], "port_frames": [], "jax_iu": [], "port_add": []}
    mp = pytest.MonkeyPatch()
    try:
        def rec_batch(fn, key):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                rec[key].append({n: np.copy(t) for n, t in out.items()})
                return out
            return wrapped

        jax_iu = jax_metrics_module.intersection_and_union

        def rec_iu(preds, label, num_class):
            rec["jax_iu"].append((np.asarray(preds), np.asarray(label)))
            return jax_iu(preds, label, num_class)

        add = port_cli.EvalAccumulator.add

        def rec_add(self, pred, gt, y_reverse=None):
            rec["port_add"].append((pred.numpy().copy(), gt.numpy().copy(),
                                    None if y_reverse is None else y_reverse.numpy().copy()))
            return add(self, pred, gt, y_reverse)

        mp.setattr(jax_synthetic, "make_batch", rec_batch(jax_make_batch, "jax_frames"))
        mp.setattr(synthetic, "make_batch", rec_batch(synthetic.make_batch, "port_frames"))
        mp.setattr(jax_metrics_module, "intersection_and_union", rec_iu)
        mp.setattr(port_cli.EvalAccumulator, "add", rec_add)
        jax_result = _jax_cli().main(
            ["--cfg", os.path.join(REPO, "fovealseg_tpu/configs/deform.yaml"), *common,
             *TINY_OPTS, *EVAL_OPTS, "DIR", str(root / "jax")])
        port_result = port_cli.main(
            ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", *common,
             *TINY_OPTS, *EVAL_OPTS, "DIR", str(root / "port")])
    finally:
        mp.undo()
    return root, jax_result, port_result, rec


def test_cli_same_frames(cli_runs):
    """Both CLIs draw 3 batches from default_rng(TRAIN.seed) and evaluate
    draws 2 and 3: the frames are equal bit for bit."""
    _, jax_result, port_result, rec = cli_runs
    assert len(rec["jax_frames"]) == len(rec["port_frames"]) == 3
    for a, b in zip(rec["jax_frames"], rec["port_frames"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert jax_result["num_batches"] == port_result["num_batches"] == 2
    gts = [g for _, g, _ in rec["port_add"]]
    for (_, jgt), gt in zip(rec["jax_iu"][1::2], gts):
        np.testing.assert_array_equal(jgt, gt)


def test_cli_accumulator_reproduces_jax_result(cli_runs):
    """The JAX CLI's own labels through the port's accumulator give the JAX
    CLI's result exactly: every key, per-class IoU included."""
    from fovealseg_torch.cli.eval import accumulate

    root, jax_result, _, rec = cli_runs
    yrev, preds = rec["jax_iu"][0::2], rec["jax_iu"][1::2]
    batches = [(torch.from_numpy(p[0].astype(np.int64)), torch.from_numpy(p[1].astype(np.int64)),
                torch.from_numpy(y[0].astype(np.int64))) for p, y in zip(preds, yrev)]
    got = accumulate(batches, _eval_cfg(root / "replay"))
    assert set(got) == set(jax_result)
    assert got == jax_result
    assert {"dice", "hd95", "trimap_acc", "y_reverse_iou"} <= set(got)


def _iou_bound(union, d):
    """Largest change of the mean IoU over the present classes when at most
    ``d`` pixels change label: |I/U - I'/U'| <= 2d / min(U, U') per class."""
    u = np.maximum(union - d, 1)
    return float(np.mean(np.minimum(2.0 * d / u, 1.0)[union > 0]))


def test_cli_end_to_end_within_label_agreement(cli_runs):
    """The two CLIs end to end. The labels agree on most pixels (the JAX
    package's CPU flood breaks border ties its own way); each metric is held
    to the bound that the measured disagreement allows: pixel accuracy moves
    by at most the disagreeing share, the mean IoU by at most
    mean(2d / U) over the classes present (d disagreeing pixels); Dice,
    each frame's Dice by at most 3 d_f / (P + G - d_f) (d_f disagreeing
    pixels, P and G its foreground areas); hd95 and the trimap, which no
    such bound covers, must be equal when every label agrees. Measured here:
    34 of 16384 labels and 85 round-trip labels differ."""
    from fovealseg_torch.cli.eval import accumulate

    root, jax_result, port_result, rec = cli_runs
    jpreds = [p for p, _ in rec["jax_iu"][1::2]]
    jyrev = [y for y, _ in rec["jax_iu"][0::2]]
    ppreds = [p for p, _, _ in rec["port_add"]]
    pyrev = [y for _, _, y in rec["port_add"]]
    n_px = sum(p.size for p in ppreds)
    d = sum(int((a != b).sum()) for a, b in zip(jpreds, ppreds))
    d_y = sum(int((a != b.astype(np.int64)).sum()) for a, b in zip(jyrev, pyrev))
    assert d / n_px <= 0.01 and d_y / n_px <= 0.05
    assert set(port_result) == set(jax_result)
    assert abs(port_result["pixel_acc"] - jax_result["pixel_acc"]) <= d / n_px + 1e-12
    gts = [g for _, g, _ in rec["port_add"]]
    union = sum(metrics.intersection_and_union(torch.from_numpy(p), torch.from_numpy(g), 51)[1]
                for p, g in zip(ppreds, gts)).numpy()
    assert abs(port_result["mean_iou"] - jax_result["mean_iou"]) <= _iou_bound(union, d) \
        + 1e-12
    yunion = sum(metrics.intersection_and_union(torch.from_numpy(y.astype(np.int64)),
                                                torch.from_numpy(g), 51)[1]
                 for y, g in zip(pyrev, gts)).numpy()
    assert abs(port_result["y_reverse_iou"] - jax_result["y_reverse_iou"]) <= \
        _iou_bound(yunion, d_y) + 1e-12
    bounds = []
    for a, b, g in zip(jpreds, ppreds, gts):
        for af, bf, gf in zip(a, b, g):
            d_f = int((af != bf).sum())
            size = int((bf != 50).sum()) + int((gf != 50).sum())
            bounds.append(3.0 * d_f / max(size - d_f, 1))
    assert abs(port_result["dice"] - jax_result["dice"]) <= np.mean(bounds) + 1e-12
    if d == 0:
        for k in ("dice", "hd95", "trimap_acc"):
            assert port_result[k] == jax_result[k], k
    # the port's own labels through its accumulator give its own result
    replay = accumulate([(torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(y))
                         for p, g, y in rec["port_add"]], _eval_cfg(root / "replay_port"))
    assert replay == port_result
    assert os.path.exists(root / "port" / "trimap_last_count_4.csv")


@pytest.mark.parametrize("opt", [["VAL.ensemble", "True"],
                                 ["VAL.approx_pred_Fxlr_by_ensemble", "True"],
                                 "--data", "resume"])
def test_cli_refuses(tmp_path, opt):
    from fovealseg_torch.cli import eval as port_cli

    args = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
            "--num-batches", "1"]
    if opt == "--data":
        _cli_on_cooked_lvis(tmp_path, args)
        return
    if opt == "resume":
        # TRAIN.start_epoch resumes from the port's training checkpoint in
        # DIR (test_torch_port_train_cli.py); an empty DIR has none to load
        with pytest.raises(FileNotFoundError, match="saliency_epoch_3.pth"):
            port_cli.main(args + TINY_OPTS + ["VAL.batch_size", "1", "TRAIN.start_epoch", "3",
                                              "DIR", str(tmp_path)])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|unset|JAX"):
        port_cli.main(args + TINY_OPTS + ["VAL.batch_size", "1"] + opt)


@pytest.mark.parametrize("opt", [["TPU.quantize", "int8"], ["TPU.conv_pack", "True"]])
def test_cli_runs_tpu_serving_options(opt):
    """The two serving options of the JAX eval CLI. ``TPU.quantize int8``
    evaluates W8A8 labels: those that the CLI's weights (``TRAIN.seed``),
    quantized by ``quantize_model``, serve through ``infer`` on the CLI's
    frames, through the plain int8 conv on the CPU. ``TPU.conv_pack``, a TPU
    layout of the same convolution, evaluates the float labels."""
    from fovealseg_torch.cli import eval as port_cli
    from fovealseg_torch.cli.infer import build_model
    from fovealseg_torch.models.layers import quantize_model
    from fovealseg_torch.ops import quant

    args = (["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
             "--num-batches", "1"] + TINY_OPTS + ["VAL.batch_size", "2"])
    preds = {}

    def keep(key):
        return lambda out, pred, gt, acc: preds.setdefault(key, pred.clone())

    base = port_cli.main(args, on_batch=keep("float"))
    calls = quant.int8_conv2d.plain_calls
    got = port_cli.main(args + opt, on_batch=keep("option"))
    assert set(got) == set(base)
    if opt[0] == "TPU.conv_pack":
        assert quant.int8_conv2d.plain_calls == calls
        assert got == base and torch.equal(preds["option"], preds["float"])
        return
    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(TINY_OPTS + ["VAL.batch_size", "2"])
    model = build_model(cfg, torch.device("cpu"))
    n = quantize_model(model)
    assert quant.int8_conv2d.plain_calls - calls == n > 0
    batch = next(port_cli.synthetic_stream(cfg, 1, 64))
    ref = model.infer(torch.from_numpy(batch["img_data"]), torch.from_numpy(batch["focus_point"]),
                      argmax_labels=True)["pred_label"]
    assert torch.equal(preds["option"], ref)
    assert 0.95 < (preds["option"] == preds["float"]).float().mean().item()


def _cli_on_cooked_lvis(tmp_path, args):
    """``--data <cook root>`` (an id of ``test_cli_refuses`` from when the
    CLI refused it): the port's reader gives the JAX reader's batches bit for
    bit, and the CLI evaluates them (labels built from those batches)."""
    from fovealseg_torch.cli import cook as port_cook
    from fovealseg_torch.cli import eval as port_cli
    from fovealseg_tpu.data.lvis import DatasetLVIS as JaxLVIS
    from tests.test_torch_port_data import assert_same
    from torch_port_files import lvis_json

    root = tmp_path / "cook"
    assert port_cook.main(["lvis", "--valid-json", lvis_json(str(tmp_path / "l.json")),
                           "--dataset-partition", "valid", "--out", str(root),
                           "--sample-num", "15", "--canvas", "64"]) == 0
    cfg = _eval_cfg(tmp_path / "unused")
    cfg.VAL.batch_size = 1
    cfg.DATASET.dataset_marker_valid = "sp3"
    want = list(JaxLVIS(str(root / "valid"), None, canvas=64, marker="sp3").batches(
        1, shuffle=False))
    got = list(port_cli.cooked_stream(cfg, str(root), None, 2, canvas=64))
    assert len(want) == 3
    assert_same(got, want[:2], "cooked batches")
    gts = []
    result = port_cli.main(args[:-1] + ["2", "--data", str(root)] + TINY_OPTS
                           + ["VAL.batch_size", "1", "DATASET.dataset_marker_valid", "sp3",
                              "DIR", str(tmp_path / "run")],
                           on_batch=lambda out, pred, gt, acc: gts.append(gt.numpy()))
    assert result["num_batches"] == 2 and 0.0 <= result["mean_iou"] <= 1.0
    for g, b in zip(gts, want):
        cls = b["cls_label"].reshape(-1)
        ref = (b["seg_label"] * cls[:, None, None] + (1 - b["seg_label"]) * 50).astype(np.int64)
        np.testing.assert_array_equal(g, ref)


def test_cli_missing_weight_file_raises(tmp_path):
    from fovealseg_torch.cli import eval as port_cli

    with pytest.raises(FileNotFoundError):
        port_cli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu",
                       "--canvas", "64", "--num-batches", "1", *TINY_OPTS,
                       "MODEL.weights_encoder", str(tmp_path / "nope.pth")])


def test_cli_visualize_and_trimap_dumps(tmp_path):
    """VAL.visualize writes the JAX CLI's eval image set (TensorBoard images,
    the per-iteration PNGs, the side-by-side dumps of the first batch), and
    VAL.trimap_visual_check the band .npy dumps of the first sample; the
    score-map path (not argmax-only) gives the same metrics as the argmax
    path on the same weights."""
    from fovealseg_torch.cli import eval as port_cli

    args = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
            "--num-batches", "1", *TINY_OPTS, "VAL.batch_size", "2", "VAL.trimap", "True",
            "VAL.trimap_dia_factor", "1"]
    plain = port_cli.main(args + ["DIR", str(tmp_path / "plain")])
    vis = port_cli.main(args + ["VAL.visualize", "True", "VAL.trimap_visual_check", "True",
                                "DIR", str(tmp_path / "vis")])
    assert vis == plain
    dumps = sorted(os.listdir(tmp_path / "vis" / "valid_visual_epoch0"))
    assert dumps == [f"iter0_batch{i}_{k}.png" for i in (0, 1) for k in ("gt_hr", "pred", "sm")]
    assert sorted(os.listdir(tmp_path / "vis" / "result")) == ["batch0_sample0.png",
                                                               "batch0_sample1.png"]
    assert os.listdir(tmp_path / "vis" / "tensorboard")
    band = np.load(tmp_path / "vis" / "trimap_visual_check" / "seg_label_Edges_dil_2.npy")
    assert band.shape == (64, 64) and band.dtype == bool and band.any()
    assert len(os.listdir(tmp_path / "vis" / "trimap_visual_check")) == 6


def test_cli_defaults_to_the_card():
    """Without --device the CLI runs on the card, and raises with none."""
    from fovealseg_torch.cli import eval as port_cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run is covered by the card's tests")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--cfg", "fovealseg_torch/configs/deform.yaml", "--canvas", "64",
                       "--num-batches", "1", *TINY_OPTS])
