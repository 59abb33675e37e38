"""Port: the serving artifact (``fovealseg_torch/cli/export.py``) on the CPU.

The tiny flagship of ``tests/test_export.py`` (48x48 canvas, 12x12 task and
saliency, ``hrnetv2_nodownsp_tiny``, radius 5, f32) with weights that the
JAX package wrote: its seeded variables through its own
``save_torch_checkpoint``, exported by the port with ``--torch-ckpt``. The
artifact's labels and scores are bit-equal to the port's live ``infer``, and
its labels agree with the JAX module's on >= 99.5% of pixels (the reason is
in ``test_torch_port_slice.py``). Also: the graph's ``fovealseg::``
operators, an eager call after an export, loading in a process that imports
only ``fovealseg_torch.ops``, the CLI's refusals, ``--format torch`` read
back by the JAX package, and ``torch.library.opcheck`` of every operator.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.configs import get_default_cfg as jax_cfg
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train.checkpoint import load_torch_checkpoint as jax_load_torch_checkpoint
from fovealseg_tpu.train.checkpoint import save_torch_checkpoint as jax_save_torch_checkpoint
from fovealseg_torch.cli import export
from tests.torch_port_zoo import cut_encoders, seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "fovealseg_torch", "configs", "deform.yaml")
TINY_OPTS = ["TRAIN.task_input_size", "(12,12)", "TRAIN.saliency_input_size", "(12,12)",
             "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5",
             "TPU.compute_dtype", "float32"]
BATCH, CANVAS = 2, 48


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cli(out, *extra, opts=()):
    return export.main(["--cfg", CFG, "--out", str(out), "--batch", str(BATCH), "--canvas",
                        str(CANVAS), "--device", "cpu", *extra, *TINY_OPTS, *opts])


def _frames(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (BATCH, CANVAS, CANVAS, 3)).astype(np.float32)
    f = np.asarray([[0.5, 0.5], [0.3, 0.7]], np.float32)
    return x, f


def _jax_module():
    cfg = jax_cfg()
    cfg.merge_from_file(os.path.join(REPO, "fovealseg_tpu", "configs", "deform.yaml"))
    cfg.merge_from_list(TINY_OPTS)
    return JaxDeform(config=JaxConfig.from_cfg(cfg))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX package's 4-file export of its seeded variables, the port's
    argmax and score artifacts of it, and the port's live model on it."""
    root = tmp_path_factory.mktemp("export")
    x0 = jnp.zeros((BATCH, CANVAS, CANVAS, 3), jnp.float32)
    v = seeded_variables(_jax_module(), x0, jnp.full((BATCH, 2), 0.5), seed=3)
    jax_save_torch_checkpoint(str(root / "jax"), 7, v["params"], v["batch_stats"],
                              also_last=False)
    src = ["--torch-ckpt", str(root / "jax"), "--torch-epoch", "7"]
    labels = _cli(root / "labels.pt2", *src)
    scores = _cli(root / "scores.pt2", *src, "--scores")
    from fovealseg_torch.cli.infer import build_model
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(CFG)
    cfg.merge_from_list(TINY_OPTS)
    live = build_model(cfg, torch.device("cpu"), str(root / "jax"), 7)
    return dict(root=root, v=v, labels=labels, scores=scores, live=live)


def _run(path, x, f):
    with torch.no_grad():
        return torch.export.load(str(path)).module()(torch.from_numpy(x), torch.from_numpy(f))


@pytest.mark.parametrize("kind", ["labels", "scores"])
def test_artifact_bit_equal_to_live_port(exported, kind):
    x, f = _frames()
    got = _run(exported[kind]["path"], x, f)
    out = exported["live"].infer(torch.from_numpy(x), torch.from_numpy(f),
                                 argmax_labels=kind == "labels")
    want = out["pred_label" if kind == "labels" else "pred_sampled"]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_artifact_labels_agree_with_jax(exported):
    x, f = _frames()
    with cut_encoders():
        ref = _jax_module().apply(exported["v"], jnp.asarray(x), jnp.asarray(f),
                                  argmax_labels=True, method=JaxDeform.infer)["pred_label"]
    got = _run(exported["labels"]["path"], x, f).numpy()
    assert got.shape == ref.shape
    assert (got == np.asarray(ref)).mean() >= 0.995


@pytest.mark.parametrize("kind,ops", [("labels", ["nearest_class"]),
                                      ("scores", ["nearest_payload_packed", "row_gather"])])
def test_graph_holds_the_kernel_operators(exported, kind, ops):
    assert exported[kind]["ops"] == ops
    program = torch.export.load(str(exported[kind]["path"]))
    assert export.kernel_ops(program) == ops
    assert exported[kind]["outputs"] == (["[2, 48, 48] torch.int32"] if kind == "labels"
                                         else ["[2, 48, 48, 51] torch.float32"])
    assert exported[kind]["bytes"] > 1_000_000  # the weights are in it
    # the resize and grid-solver matrices are constants on the program's device,
    # read from the caches that the exporter's eager call warmed, none made from
    # host data in the graph (which would copy it to the device on every call)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "aten.lift_fresh_copy.default" not in targets
    assert program.constants and all(t.device.type == "cpu" for t in program.constants.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_eager_call_after_export_equals_a_fresh_model(dtype):
    """No cache of device tensors keeps a tensor made under a trace: a model
    traced with the caches empty and before any eager call (as any
    ``torch.export`` of it, without the exporter's warming call) then serves
    eagerly what a fresh model serves; so does the exporter's program."""
    from fovealseg_torch.core import grid, interpolate
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(12, 12), task_hw_infer=(12, 12), saliency_hw=(12, 12),
                       gaussian_radius=5, arch_encoder="hrnetv2_nodownsp_tiny")

    def fresh():
        model = DeformSegmentation(cfg, dtype=dtype, device="cpu")
        return init_weights(model, torch.Generator().manual_seed(304))

    grid._solver_tensors.cache_clear()
    interpolate._resize_matrix.cache_clear()
    model = fresh()
    x0, f0 = torch.zeros((BATCH, CANVAS, CANVAS, 3)), torch.full((BATCH, 2), 0.5)
    with torch.no_grad():
        torch.export.export(export.ServingProgram(model, False), (x0, f0), strict=False)
    x, f = (torch.from_numpy(a) for a in _frames(11))
    after = model.infer(x, f, argmax_labels=True)
    want = fresh().infer(x, f, argmax_labels=True)
    for key in ("pred_label", "pred", "grid"):
        assert torch.equal(after[key], want[key]), key
    program = export.export_serving(model, BATCH, CANVAS)
    assert torch.equal(program.module()(x, f), want["pred_label"])


def test_artifact_loads_where_only_the_ops_are_imported(exported, tmp_path):
    """A process that imports ``fovealseg_torch.ops`` and nothing else of the
    repository loads and runs the artifact."""
    x, f = _frames(5)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "f.npy", f)
    script = (
        "import sys, numpy as np, torch\n"
        "import fovealseg_torch.ops\n"
        "serve = torch.export.load(sys.argv[1]).module()\n"
        "x, f = (torch.from_numpy(np.load(p)) for p in sys.argv[2:4])\n"
        "np.save(sys.argv[4], serve(x, f).numpy())\n"
        "mods = sorted(m for m in sys.modules if m.startswith(('fovealseg', 'jax')))\n"
        "assert mods == ['fovealseg_torch', 'fovealseg_torch.ops', 'fovealseg_torch.ops.gather',"
        " 'fovealseg_torch.ops.jfa', 'fovealseg_torch.ops.library', 'fovealseg_torch.ops.quant'],"
        " mods\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-c", script, str(exported["labels"]["path"]),
                    str(tmp_path / "x.npy"), str(tmp_path / "f.npy"), str(tmp_path / "y.npy")],
                   check=True, env=env, cwd=tmp_path, timeout=300)
    want = exported["live"].infer(torch.from_numpy(x), torch.from_numpy(f),
                                  argmax_labels=True)["pred_label"]
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want.numpy())


@pytest.mark.parametrize("extra,opts,message", [
    (["--format", "stablehlo", "--allow-random"], [], None),
    ([], [], None),  # no weight source and no --allow-random
    (["--allow-random"], ["MODEL.rev_deform_interp", "tri"], None),
    (["--allow-random"], ["MODEL.uniform_sample", "BI"], "holds the kernel operators none"),
], ids=["stablehlo", "random_weights", "tri_exact", "no_kernel_operator"])
def test_refusals(tmp_path, capsys, extra, opts, message):
    out = tmp_path / "refused.pt2"
    with pytest.raises(SystemExit) as exc:
        _cli(out, *extra, opts=opts)
    if message:
        assert message in str(exc.value)
    else:
        assert exc.value.code == 2  # argparse's error
    assert not out.exists()


def test_allow_random_and_tri_splat_export(tmp_path):
    """``--allow-random`` writes the seeded init; 'tri' with TPU.tri_exact
    False exports the device splat fill (K4 and K5)."""
    res = _cli(tmp_path / "tri.pt2", "--allow-random", "--scores",
               opts=["MODEL.rev_deform_interp", "tri", "TPU.tri_exact", "False"])
    assert res["source"] == "random" and res["ops"] == ["nearest_seed", "row_gather"]
    assert os.path.getsize(tmp_path / "tri.pt2") == res["bytes"]


def _jax_template():
    x0 = jnp.zeros((1, CANVAS, CANVAS, 3), jnp.float32)
    return seeded_variables(_jax_module(), x0, jnp.full((1, 2), 0.5), seed=99)


def _assert_tree_equal(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_want[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_format_torch_from_a_torch_checkpoint_reads_back_into_jax(exported, tmp_path):
    """``--torch-ckpt DIR --torch-epoch 7 --format torch``: the files of tag 7
    and their ``_last`` copies, which the JAX package's loader reads back as
    the variables it wrote, exactly."""
    res = _cli(tmp_path / "out", "--format", "torch", "--torch-ckpt",
               str(exported["root"] / "jax"), "--torch-epoch", "7")
    assert res["tag"] == "7"
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{kind}_epoch_{tag}.pth" for kind in ("saliency", "compress", "encoder", "decoder")
        for tag in (7, "last"))
    template = _jax_template()
    for tag in (7, "last"):
        params, stats = jax_load_torch_checkpoint(str(tmp_path / "out"), tag,
                                                  template["params"], template["batch_stats"])
        _assert_tree_equal(params, exported["v"]["params"])
        _assert_tree_equal(stats, exported["v"]["batch_stats"])


def test_format_torch_tags_random_and_training_checkpoints(tmp_path):
    """Random weights: tag 'last', one file per kind. The port's training
    checkpoint (``DIR`` at ``TRAIN.start_epoch``, through ``load_checkpoint``):
    tag N with ``_last`` copies, holding the checkpoint's weights."""
    from fovealseg_torch.cli.infer import build_model
    from fovealseg_torch.configs import get_default_cfg
    from fovealseg_torch.train.checkpoint import save_checkpoint
    from fovealseg_torch.train.optim import create_optimizer
    from fovealseg_torch.train.step import init_state

    res = _cli(tmp_path / "random", "--format", "torch", "--allow-random")
    assert res["source"] == "random" and res["tag"] == "last"
    assert sorted(os.listdir(tmp_path / "random")) == sorted(
        f"{kind}_epoch_last.pth" for kind in ("saliency", "compress", "encoder", "decoder"))

    cfg = get_default_cfg()
    cfg.merge_from_file(CFG)
    cfg.merge_from_list(TINY_OPTS + ["TRAIN.seed", "5"])
    model = build_model(cfg, torch.device("cpu"))
    save_checkpoint(str(tmp_path / "run"), 3, init_state(model, create_optimizer(cfg, model), 5))
    res = _cli(tmp_path / "from_run", "--format", "torch",
               opts=["DIR", str(tmp_path / "run"), "TRAIN.start_epoch", "3"])
    assert res["source"] == "checkpoint" and res["tag"] == 3
    sd = model.state_dict()
    for tag in (3, "last"):
        enc = torch.load(tmp_path / "from_run" / f"encoder_epoch_{tag}.pth", weights_only=True)
        assert set(enc) == {k[len("encoder."):] for k in sd if k.startswith("encoder.")}
        for k, t in enc.items():
            assert torch.equal(t, sd[f"encoder.{k}"]), k


def _op_cases():
    g = torch.Generator().manual_seed(0)
    valid = torch.rand((2, 24, 20), generator=g) > 0.9
    pay = torch.randint(0, 50, (2, 24, 20), generator=g, dtype=torch.int32)
    rounds = torch.tensor([3], dtype=torch.int32)
    idx = torch.randint(-2, 40, (2, 6, 7), generator=g, dtype=torch.int32)
    return {"nearest_class": (valid, pay, rounds),
            "nearest_payload_packed": (valid, pay, rounds),
            "nearest_payload": (valid, pay, rounds),
            "nearest_seed": (valid, rounds),
            "row_gather": (torch.randn((2, 38, 5), generator=g), idx),
            "row_gather_backward": (torch.randn((2, 6, 7, 5), generator=g), idx, 38),
            **_quant_cases(g)}


def _quant_cases(g):
    """The W8A8 conv's operator (``ops/quant.py``) on small inputs: f32 with a
    bias, 3x3 stride 2; bf16 without, 1x1; f32, 3x3 unpadded. A case
    ``<op>.<variant>`` runs ``torch.ops.fovealseg.<op>``."""
    x = torch.randn((2, 16, 5, 7), generator=g)
    wq = torch.randint(-127, 128, (32, 3, 3, 16), generator=g, dtype=torch.int8)
    wq1 = torch.randint(-127, 128, (32, 1, 1, 16), generator=g, dtype=torch.int8)
    ws = torch.rand(32, generator=g) / 100
    return {"w8a8_conv2d": (x, wq, ws, torch.randn(32, generator=g), 2, 1),
            "w8a8_conv2d.bf16": (x.bfloat16(), wq1, ws, None, 1, 0),
            "w8a8_conv2d.unpadded": (x, wq, ws, None, 1, 0)}


def _w8a8_plain(x, weight_q, w_scale, bias, stride, padding):
    from fovealseg_torch.ops import quant

    s_x = quant.absmax_scale_plain(x)
    return quant.int8_conv2d_plain(quant.quantize_act_plain(x, s_x), weight_q, s_x, w_scale,
                                   bias, stride, padding, x.dtype)


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_opcheck_on_the_cpu(name):
    """``torch.library.opcheck`` (schema, autograd registration, the fake
    kernel against the CPU kernel, tracing with dynamic shapes) of each
    registered operator; the CPU kernel is the wrapper's plain version."""
    import fovealseg_torch.ops  # noqa: F401

    args = _op_cases()[name]
    op = getattr(torch.ops.fovealseg, name.split(".")[0]).default
    torch.library.opcheck(op, args)
    from fovealseg_torch.ops import gather, jfa

    plain = {"nearest_class": lambda v, p, r: jfa.nearest_class_plain(v, p, 6, r),
             "nearest_payload_packed": lambda v, p, r: jfa.nearest_payload_packed_plain(v, p, 6, r),
             "nearest_payload": jfa.nearest_payload_plain, "nearest_seed": jfa.nearest_seed_plain,
             "row_gather": gather.row_gather_plain,
             "row_gather_backward": gather.row_gather_backward_plain,
             "w8a8_conv2d": _w8a8_plain}[name.split(".")[0]]
    assert torch.equal(op(*args), plain(*args))
