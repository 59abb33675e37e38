"""Port: ``fovealseg_torch/utils/{torch_tools,dynamicfocus,misc,observe,plot}.py``
against their JAX-package counterparts on the cases of ``tests/test_utils.py``
that need no reference checkout, on the same seeded inputs: numpy results
exact (the port's copies run the same operations), float results within
1e-6. The model helpers take an ``nn.Module`` where the JAX package takes a
flax parameter tree, so they are held on the same shapes: equal totals,
and the JAX test's statistics for the random init.
"""

import datetime
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_torch.utils import dynamicfocus as tdf
from fovealseg_torch.utils import misc as tmisc
from fovealseg_torch.utils import observe as tobs
from fovealseg_torch.utils import torch_tools as ttt
from fovealseg_tpu.utils import dynamicfocus as jdf
from fovealseg_tpu.utils import misc as jmisc
from fovealseg_tpu.utils import observe as jobs
from fovealseg_tpu.utils import torch_tools as jtt


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torch_tools_against_jax(rng):
    x = rng.integers(0, 9, (2, 8, 16))
    _eq(ttt.cross_unfold(x, 2), jtt.cross_unfold(x, 2))
    assert (ttt.cross_fold(ttt.cross_unfold(x, 2)) == x).all()
    m = np.array([[1, 1, 2, 2], [1, 3, 2, 2], [0, 0, 5, 5], [0, 0, 5, 5]])
    _eq(ttt.interpolate_int(m, 1), jtt.interpolate_int(m, 1))
    assert ttt.interpolate_int(m, 1).tolist() == [[1, 2], [0, 5]]
    assert ttt.get_padding(30, 62, 32) == jtt.get_padding(30, 62, 32)
    assert ttt.get_padding_to_canvas(30, 62, 64, 64) == jtt.get_padding_to_canvas(30, 62, 64, 64)
    img = rng.random((2, 3, 5, 7)).astype(np.float32)
    alpha = rng.random((5, 7)).astype(np.float32)
    for a in (None, alpha):
        _eq(ttt.add_alpha(img, a), jtt.add_alpha(img, a))
    k = rng.random((2, 4, 6, 3, 3)).astype(np.float32)
    _eq(ttt.kernel_swap(k), jtt.kernel_swap(k))
    t = rng.random(32).astype(np.float32) * 10 - 5
    np.testing.assert_allclose(ttt.gaussian_function(t, 1.0, 2.5),
                               jtt.gaussian_function(t, 1.0, 2.5), rtol=1e-6)
    np.testing.assert_allclose(ttt.gen_focus_gaussian_hw(3, 9, 16, 24, std=8.0),
                               jtt.gen_focus_gaussian_hw(3, 9, 16, 24, std=8.0), rtol=1e-6)
    assert ttt.str_tensor_shape(img) == jtt.str_tensor_shape(img) == "2x3x5x7"


def test_dynamicfocus_against_jax(rng):
    for args in [(0, 0, 16, 16, 4, 4), (15, 15, 16, 16, 4, 4), (8, 8, 16, 16, 5, 5),
                 (3, 12, 16, 16, 20, 6)]:
        import random

        assert (tdf.get_idxs_crop4(*args, rng=random.Random(3))
                == jdf.get_idxs_crop4(*args, rng=random.Random(3)))
    preds, tgts = rng.integers(0, 3, 100), rng.integers(0, 3, 100)
    cm = tdf.calc_confusion_matrix(preds, tgts, 3)
    _eq(cm, jdf.calc_confusion_matrix(preds, tgts, 3))
    _eq(tdf.calc_metrics(cm), jdf.calc_metrics(cm))
    p, q = rng.uniform(0, 1, (2, 8, 8)), rng.uniform(0, 1, (2, 8, 8))
    _eq(tdf.evaluate_segmentation(p, q), jdf.evaluate_segmentation(p, q))
    scores = rng.random((40, 4))
    target = rng.integers(0, 4, 40)
    _eq(tdf.evaluate_classification(scores, target, 4),
        jdf.evaluate_classification(scores, target, 4))
    x = rng.normal(0, 2, (4, 3, 8, 8)).astype(np.float32)
    for fn in ("cd_cdf", "a_gd_cdf", "standardize_bchw", "scale01_bchw"):
        _eq(getattr(tdf, fn)(x), getattr(jdf, fn)(x))
    lo, hi = tdf.EarlyStopMin(), tdf.EarlyStopMax()
    assert [lo.check(v) for v in (1.0, 2.0, 0.5)] == [True, False, True]
    assert [hi.check(v) for v in (1.0, 0.5, 2.0)] == [True, False, True]
    w = tdf.Watch()
    w.start()
    assert w.stop() >= 0 and tdf.watch_time(lambda: 7)() == 7


def test_misc_against_jax(tmp_path):
    for spec in ("0-3", "gpu0,gpu2", "0,1,1", "gpu3-gpu1"):
        assert tmisc.parse_devices(spec) == jmisc.parse_devices(spec)
    with pytest.raises(tmisc.NotSupportedCliException):
        tmisc.parse_devices("tpu0")
    (tmp_path / "a").mkdir()
    for name in ("a/x.jpg", "y.jpg", "z.png"):
        (tmp_path / name).write_bytes(b"")
    assert (sorted(tmisc.find_recursive(str(tmp_path), ".jpg"))
            == sorted(jmisc.find_recursive(str(tmp_path), ".jpg")))
    preds, label = np.array([1, 0, 1, 1]), np.array([1, 0, -1, 0])
    assert tmisc.accuracy_ltds(preds, label) == jmisc.accuracy_ltds(preds, label)
    lt, lp = np.array([0, 1, 8, 2]), np.array([0.6, 0.4, 0.9, 0.2])
    _eq(tmisc.preprocessing_accuracy(lt, lp, 2), jmisc.preprocessing_accuracy(lt, lp, 2))


def test_observe_io_against_jax(tmp_path, rng, capsys):
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    img = rng.random((6, 5, 3)).astype(np.float32)
    for mod, tag in ((tobs, "t"), (jobs, "j")):
        mod.save_json({"a": 1}, str(tmp_path / f"{tag}.json"))
        mod.save_jsonl(rows, str(tmp_path / f"{tag}.jsonl"))
        mod.save_pickle({"k": [1, 2]}, str(tmp_path / f"{tag}.pkl"))
        mod.save_text("héllo\nworld", str(tmp_path / f"{tag}.txt"))
        mod.save_image(img, str(tmp_path / f"{tag}.png"))
    for ext in ("json", "jsonl", "pkl", "txt", "png"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes(), ext
    assert tobs.load_json(str(tmp_path / "j.json")) == {"a": 1}
    assert tobs.read_jsonl(str(tmp_path / "j.jsonl")) == rows
    assert tobs.load_pickle(str(tmp_path / "j.pkl")) == {"k": [1, 2]}
    assert tobs.read_text(str(tmp_path / "j.txt")) == "héllo\nworld"
    _eq(tobs.load_image(str(tmp_path / "t.png")), jobs.load_image(str(tmp_path / "t.png")))
    arr = rng.standard_normal((3, 4)).astype(np.float32)
    tobs.save_tensor(torch.from_numpy(arr), str(tmp_path / "t.npy"))
    jobs.save_tensor(jnp.asarray(arr), str(tmp_path / "j.npy"))
    _eq(tobs.load_tensor(str(tmp_path / "t.npy")), jobs.load_tensor(str(tmp_path / "j.npy")))

    d = datetime.date(2026, 8, 20)
    assert tobs.date2datetime(d) == jobs.date2datetime(d) == datetime.datetime(2026, 8, 20)
    assert tobs.get_args_kwargs(1, 2, k=3) == ((1, 2), {"k": 3})
    df = tobs.get_df_by_dctns_cols(rows, ["a", "b"])
    assert tobs.get_dctns_cols_by_df(df) == jobs.get_dctns_cols_by_df(df) == (rows, ["a", "b"])
    bag = tobs.RAM()
    bag.t = np.ones(3)
    bag.gc()
    assert not hasattr(bag, "t")
    assert tobs.byte2mb(3 * 1024**2) == jobs.byte2mb(3 * 1024**2) == 3.0
    capsys.readouterr()
    tobs.pbox(["line1", "line2"])
    tobs.xprint("hello")
    out = capsys.readouterr().out
    assert out.startswith("line1\nline2\n[") and out.endswith("hello\n")
    logger = logging.getLogger("fovealseg")
    handlers, level = logger.handlers[:], logger.level
    try:
        log = tobs.setup_logger(0, str(tmp_path / "log.txt"))
        log.info("to the file")
        assert "to the file" in (tmp_path / "log.txt").read_text()
        assert tobs.setup_logger(1).handlers == []
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers[:] = handlers
        logger.setLevel(level)


def test_model_helpers(capsys):
    model = torch.nn.ModuleDict({"conv": torch.nn.Conv2d(4, 8, 3),
                                 "dense": torch.nn.Linear(8, 2, bias=False)}).requires_grad_(False)
    params = {"conv": {"kernel": jnp.ones((3, 3, 4, 8), jnp.float32), "bias": jnp.zeros((8,))},
              "dense": {"kernel": jnp.ones((8, 2), jnp.float32)}}
    n_ele = 3 * 3 * 4 * 8 + 8 + 16
    arr = np.zeros((256, 1024), np.float32)
    assert tobs.calc_tensor_memsize(torch.from_numpy(arr)) == jobs.calc_tensor_memsize(arr) == 1.0
    assert (tobs.calc_model_memsize(model, "KB", show=False)
            == jobs.calc_model_memsize(params, "KB", show=False) == n_ele * 4 / 1024)
    capsys.readouterr()
    ele, mem = tobs.show_model_info(model, show_details=True)
    out = capsys.readouterr().out
    assert (ele, mem) == jobs.show_model_info(params, show_details=False)
    assert ele == n_ele and "conv.weight" in out and "Total Trainable" in out
    with pytest.raises(ValueError):
        tobs.calc_tensor_memsize(torch.zeros(2), "TB")

    tobs.init_weights_zero(model)
    assert all(float(p.abs().max()) == 0.0 for p in model.parameters())
    model["bn"] = torch.nn.BatchNorm1d(8).requires_grad_(False)
    tobs.init_weights_random(model, torch.Generator().manual_seed(0))
    # the JAX test's statistics: xavier_normal_ with the receptive field in
    # the fans, std = sqrt(2 / (4*9 + 8*9)) ~ 0.136; biases 0; BN weights N(1, 0.02)
    assert abs(float(model["conv"].weight.std()) - 0.136) < 0.05
    assert float(model["conv"].bias.abs().max()) == 0.0
    assert abs(float(model["bn"].weight.mean()) - 1.0) < 0.05
    assert float(model["bn"].weight.std()) < 0.1


def test_devices_without_a_card():
    assert tobs.try_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tobs.try_device("tpu")
    if torch.cuda.is_available():
        assert tobs.try_device().type == "cuda" and len(tobs.device_memory_stats()) >= 1
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tobs.try_device()
        assert tobs.device_memory_stats() == []


def test_plot_helpers(tmp_path, rng):
    from fovealseg_torch.utils.plot import plt_imgshow, plt_multi_imgshow

    rgb = rng.random((3, 8, 10)).astype(np.float32)
    assert plt_imgshow(rgb, "rgb") is not None
    fig = plt_multi_imgshow([rgb, rgb[0], None], ["a", "b", "c"], row_col=(1, 3))
    fig.savefig(str(tmp_path / "fig.png"))
    assert (tmp_path / "fig.png").stat().st_size > 0
    assert [ax.get_visible() for ax in fig.axes[:3]] == [True, True, False]
