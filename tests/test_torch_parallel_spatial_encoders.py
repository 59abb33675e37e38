"""Port: row-partitioned single-frame serving (``parallel/spatial.py``,
``cli.infer --spatial``) with SegFormer and DeepLab, and the row hooks of
``models/layers.py`` that their forwards take, on the CPU, gloo rank
processes.

The encoders are cut as ``tests/torch_port_zoo.py::cut_encoders`` cuts them
(SegFormer ``TINY_MIT``, DeepLab one Bottleneck per layer), at the tiny size
of ``test_torch_parallel_spatial.py`` (16x16 task, radius 5, 64x64 canvas,
51 classes); the JAX package's variables filled from a numpy seed, carried
over with ``from_jax_variables``. One launch of four ranks
(``torch_parallel_workers.py::spatial_encoders``, which cuts the port's
builder in each rank) serves both encoders over 4 ranks and over 2, and
runs the hooks over both; one thread and oneDNN off on every side, as in
``test_torch_parallel_spatial.py``.

* The hooks against the whole tensor: the max pool (3x3, stride 2, pad 1,
  DeepLab's stem) on negative inputs bit-equal to ``torch.max_pool2d``,
  and the same pool with rows off the image filled with zero shown to
  differ from it; the gathers of a map and of its tokens bit-equal; the
  mean with ``keepdim`` within 1e-6; a 3x3 conv of dilation 36 and padding
  36 (DeepLab's widest ASPP branch) over a 10-row map whose blocks
  follow an 80-row task (3, 2, 3, 2 rows over 4 ranks: every rank reads
  every other rank's block and zero rows) within 1e-6. The max pool, the
  gather and the mean also on a 2-row map over 4 ranks, where ranks 1-3
  hold empty blocks.
* The spatial eval forward and ``infer`` of each encoder over 4 ranks and
  over 2 against the port's one-process forward: ``pred`` and
  ``pred_sampled`` within 1e-4 absolute, ``pred_label`` equal on every
  pixel whose top-two score margin exceeds 1e-4 (the largest difference,
  the count past rtol 1e-5 and the undecided pixels are printed); the
  reasons are those of ``test_torch_parallel_spatial.py``. At 16x16 over 4
  ranks the 1/8 level has 2 rows, so ranks 1 and 3 hold empty blocks
  there: SegFormer's stage 4 attends with zero queries and normalises zero
  tokens, DeepLab's layers 2-4, ASPP and tail run on empty blocks.
* The 4-rank forward against the JAX package's ``make_spatial_infer_fn`` at
  4 shards (``method='forward'``; its row constraint passes through the
  ``flax.linen.jit`` that ``cut_encoders`` wraps each sub-network in):
  within 1e-5 of the largest magnitude, the f32 tolerance between the two
  packages of ``test_torch_port_{segformer,deeplab}.py``.
* bf16 over 4 ranks against one process's bf16: ``pred`` and
  ``pred_sampled`` within 3e-2 of the largest magnitude, the bf16 eval
  tolerance of those files. bf16 runs with oneDNN on, on both sides:
  PyTorch's own CPU convs take ~30 s for the cut DeepLab's dilated convs
  in bf16.
* The serving CLI at full depth (SegFormer-B5, ``MODEL.fc_dim 1024``, and
  DeepLabV3-R101, seeded from ``TRAIN.seed``): ``--spatial 2`` gives the
  one-process labels on the decided pixels.
* ``row_aware`` raises for a plain ``nn.Conv2d``, before it swaps any conv.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.parallel.mesh import make_mesh_spatial, make_spatial_infer_fn
from fovealseg_torch.cli import infer as infer_cli
from fovealseg_torch.models import layers
from fovealseg_torch.models.deform_module import DeformConfig
from fovealseg_torch.parallel import spatial
from fovealseg_torch.parallel.launch import run_workers
from fovealseg_torch.train.checkpoint import from_jax_variables
from tests.test_encoders import TINY_MIT

import torch_parallel_workers as W
from test_torch_parallel_spatial import SERVE, TINY, _masks, decided
from torch_port_zoo import cut_encoders, rel_err, seeded_variables, slice_config

ENCODERS = ("segformer", "deeplab")
# the CLI's full-depth encoders: MODEL.fc_dim is the decoder's input width
FULL = {"segformer": ["MODEL.arch_encoder", "segformer", "MODEL.fc_dim", "1024"],
        "deeplab": ["MODEL.arch_encoder", "deeplab"]}


def _op_inputs() -> dict:
    """The hooks' whole inputs, from a numpy seed: negative maps for the
    pools (a zero fill then wins the border windows), a 10-row map and a
    conv of dilation 36."""
    rng = np.random.default_rng(11)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, size=shape).astype(np.float32))

    return {"pool9": t(1, 3, 9, 5, lo=-2.0, hi=-0.5), "pool2": t(1, 3, 2, 5, lo=-2.0, hi=-0.5),
            "map9": t(1, 4, 9, 5), "conv10": t(1, 8, 10, 6),
            "conv_state": {"weight": t(8, 8, 3, 3), "bias": t(8)}}


def _one_process(sd, cfg, x, f, dtype) -> dict:
    model = W.tiny_model(sd, DeformConfig(**cfg), dtype)
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=dtype == torch.bfloat16):
        one = {"pred_forward": model(xt, ft)["pred"], **model.infer(xt, ft)}
        one["pred_label"] = model.infer(xt, ft, argmax_labels=True)["pred_label"]
    return one


def _cli_reference(enc: str) -> tuple:
    """One process's scores and labels on the serving CLI's frames, from the
    model that the CLI seeds."""
    args, cfg, _ = infer_cli._parse(SERVE + ["--batch", "2"] + TINY + FULL[enc])
    model = infer_cli.build_model(cfg, torch.device("cpu"))
    scores, labels = [], []
    for _, x, f in infer_cli.synthetic_batches(args.num_batches, args.canvas, 2):
        x, f = torch.from_numpy(x), torch.from_numpy(f)
        with torch.no_grad():
            scores.append(model.infer(x, f)["pred_sampled"].numpy())
            labels.append(model.infer(x, f, argmax_labels=True)["pred_label"].numpy())
    return np.concatenate(scores), np.concatenate(labels)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The ranks' launch and the two CLI serves start first; the one-process
    and JAX references are computed here meanwhile (one thread, oneDNN
    off)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    f = np.array([[0.5, 0.5], [0.25, 0.75]], np.float32)
    root = tmp_path_factory.mktemp("spatial_encoders")
    ops = _op_inputs()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(3) as pool, torch.backends.mkldnn.flags(enabled=False):
            clis = {enc: pool.submit(infer_cli.main, SERVE + ["--batch", "2", "--spatial", "2",
                                                              "--out", str(root / enc)]
                                     + TINY + FULL[enc])
                    for enc in ENCODERS}
            with cut_encoders():
                cfgs = {enc: slice_config(enc) for enc in ENCODERS}
                vs = {enc: seeded_variables(JaxDeform(config=JaxConfig(**cfgs[enc])),
                                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)), seed=3)
                      for enc in ENCODERS}
                sds = {enc: from_jax_variables(v["params"], v["batch_stats"])
                       for enc, v in vs.items()}
                ranks = pool.submit(run_workers, 4, W.spatial_encoders, sds, x, f, cfgs, TINY_MIT,
                                    ops, device="cpu", timeout=600, threads=1)
                one = {(enc, dt): _one_process(sds[enc], cfgs[enc], x, f, getattr(torch, dt))
                       for enc in ENCODERS for dt in ("float32", "bfloat16")}
                jax_ref = {}
                for enc in ENCODERS:
                    _, fn = make_spatial_infer_fn(JaxConfig(**cfgs[enc]), make_mesh_spatial(4),
                                                  method="forward")
                    jax_ref[enc] = np.asarray(fn(vs[enc], jnp.asarray(x), jnp.asarray(f)))
            cli_ref = {enc: _cli_reference(enc) for enc in ENCODERS}
            yield dict(one=one, jax=jax_ref, ranks=ranks, clis=clis, cli_ref=cli_ref, ops=ops,
                       root=root)
    finally:
        torch.set_num_threads(prev)


def _ranks(setup, world: str) -> list:
    got = [r[world] for r in setup["ranks"].result() if world in r]
    assert len(got) == int(world)
    return got


def _blocks(ranks, name):
    return torch.cat([r["ops"][name] for r in ranks], dim=2)


@pytest.mark.parametrize("world", ["4", "2"])
def test_row_max_pool_fills_rows_off_the_image_with_minus_inf(setup, world):
    """Negative inputs: a window over the top or bottom border row takes its
    maximum from the image, where a zero row would win."""
    ranks, ops = _ranks(setup, world), setup["ops"]
    for name, key in (("max_pool", "pool9"), ("max_pool_empty", "pool2")):
        want = torch.max_pool2d(ops[key], 3, 2, 1)
        assert torch.equal(_blocks(ranks, name), want), name
    # the same pool with a zero fill: the border rows' windows take the zero
    zero, want = _blocks(ranks, "max_pool_zero_fill"), torch.max_pool2d(ops["pool9"], 3, 2, 1)
    assert zero.shape == want.shape and not torch.equal(zero, want)
    assert (zero[:, :, 0] == 0).all() and (zero[:, :, -1] == 0).all()
    # the first op at a task height: the global height's all-reduce, then the slabs
    assert ranks[0]["ops"]["max_pool_exchanges"] == 2
    # 2 rows over 4 ranks, one output row: ranks 1-3 hold empty blocks
    if world == "4":
        assert [r["ops"]["max_pool_empty"].shape[2] for r in ranks] == [1, 0, 0, 0]


@pytest.mark.parametrize("world", ["4", "2"])
def test_trunk_gather_and_mean(setup, world):
    ranks, ops = _ranks(setup, world), setup["ops"]
    for r in ranks:
        assert torch.equal(r["ops"]["gather"], ops["map9"])
        assert torch.equal(r["ops"]["gather_empty"], ops["pool2"])
        assert torch.equal(r["ops"]["gather_tokens"], ops["map9"].flatten(2).transpose(1, 2))
        for name, key in (("mean", "map9"), ("mean_empty", "pool2")):
            want = ops[key].mean(dim=(2, 3), keepdim=True)
            assert r["ops"][name].shape == want.shape == (1, ops[key].shape[1], 1, 1)
            torch.testing.assert_close(r["ops"][name], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", ["4", "2"])
def test_rate_36_conv_over_ten_rows(setup, world):
    """DeepLab's widest ASPP tap at the flagship's 1/8 level (10 rows): each
    rank's needed rows span the whole map and 36 zero rows on each side."""
    ranks = _ranks(setup, world)
    got = _blocks(ranks, "conv_rate36")
    want = ranks[0]["ops"]["conv_rate36_whole"]
    heights = [r["ops"]["conv_rate36"].shape[2] for r in ranks]
    assert heights == ([3, 2, 3, 2] if world == "4" else [5, 5])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert all(r["ops"]["conv_rate36_exchanges"] == 2 for r in ranks)


@pytest.mark.parametrize("world", ["4", "2"])
@pytest.mark.parametrize("enc", ENCODERS)
def test_spatial_forward_and_infer_match_one_process(setup, enc, world):
    one = setup["one"][enc, "float32"]
    ok = decided(one["pred_sampled"].numpy())
    print(f"{enc}, {world} ranks: {(~ok).sum()} of {ok.size} full-res pixels undecided")
    for r in _ranks(setup, world):
        got = r[f"{enc} float32"]
        assert got["exchanges_forward"] > 10
        for key in ("pred_forward", "pred", "pred_sampled"):
            a, b = got[key].numpy(), one[key].numpy()
            assert a.shape == b.shape
            loose = np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)
            print(f"{enc}, {world} ranks, {key}: largest difference {np.abs(a - b).max():.3g} "
                  f"of {np.abs(b).max():.3g}; {loose.sum()} of {loose.size} past rtol 1e-5 + "
                  f"atol 1e-5")
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_array_equal(got["pred_label"].numpy()[ok],
                                      one["pred_label"].numpy()[ok])


@pytest.mark.parametrize("enc", ENCODERS)
def test_spatial_forward_matches_jax_spatial_forward(setup, enc):
    """JAX's ``make_spatial_infer_fn`` at 4 shards against the port's four
    ranks: the warped-domain logits."""
    got = _ranks(setup, "4")[0][f"{enc} float32"]["pred_forward"].numpy()
    err = rel_err(got, setup["jax"][enc])
    print(f"{enc}: port 4 ranks against JAX 4 shards {err:.3g}")
    assert err <= 1e-5


@pytest.mark.parametrize("enc", ENCODERS)
def test_bf16_spatial_matches_one_process(setup, enc):
    one = setup["one"][enc, "bfloat16"]
    for r in _ranks(setup, "4"):
        got = r[f"{enc} bfloat16"]
        assert got["exchanges_forward"] > 10
        for key in ("pred_forward", "pred_sampled"):
            err = rel_err(got[key].float().numpy(), one[key].float().numpy())
            print(f"{enc} bf16, 4 ranks, {key}: {err:.3g} of the largest magnitude")
            assert err <= 3e-2, key


@pytest.mark.parametrize("enc", ENCODERS)
def test_cli_spatial_gives_the_one_process_labels(setup, enc):
    ranks = setup["clis"][enc].result()
    assert len(ranks) == 2 and ranks[0]["spatial"] == 2 and ranks[0]["frames"] == 2
    assert ranks[0]["exchanges"] > 0 and ranks[0]["exchanges"] == ranks[1]["exchanges"]
    scores, want = setup["cli_ref"][enc]
    got = _masks(setup["root"] / enc)
    ok = decided(scores)
    print(f"{enc} --spatial 2: {(~ok).sum()} of {ok.size} pixels undecided")
    assert got.shape == want.shape == ok.shape
    np.testing.assert_array_equal(got[ok], want[ok])


def test_row_aware_refuses_a_plain_conv():
    net = torch.nn.Sequential(layers.conv2d(3, 4, 3, 1, 1), torch.nn.Conv2d(4, 4, 1))
    with pytest.raises(NotImplementedError, match="row-partitioned Conv2d"):
        spatial.row_aware(net)
    assert type(net[0]) is layers.Conv2d  # nothing swapped
