"""Port: row-partitioned single-frame serving (``cli.infer --spatial``,
``parallel/spatial.py``) and ``--mesh`` with a ``_nonsyn`` saliency net, on
the CPU, gloo rank processes, at the tiny size (``hrnetv2_nodownsp_tiny``,
16x16 task, radius 5, 64x64 canvas, 51 classes; the JAX package's variables
filled from a numpy seed, carried over with ``from_jax_variables``).

* The spatial eval forward and ``infer`` over 4 ranks and over 2 (one
  launch of four ranks, ``torch_parallel_workers.py::spatial_serve``)
  against the port's one-process forward: ``pred`` and ``pred_sampled``
  within 1e-4 absolute (logits of magnitude up to 88; the largest
  difference read is 4.03e-5), ``pred_label`` equal
  on every pixel whose top-two score margin exceeds 1e-4 (the undecided
  pixels counted and printed). The JAX package holds its spatial forward
  to rtol 1e-5 and atol 1e-5 (``tests/test_parallel_spatial.py``): XLA
  partitions the same per-element sums. PyTorch's CPU GEMM sums a row
  block's outputs in another order than the whole image's, and C1's class
  logits, sums of 512 products, carry that to a few small logits past rtol
  1e-5 (the count is printed); 1e-4 still fails any wrong halo row by
  orders of magnitude. At 16x16 over 4 ranks the 1/8 level has 2 rows, so
  two ranks hold an empty block there. oneDNN is off and one thread runs on
  both sides: oneDNN picks a strided conv's algorithm by the input's
  height, and the reference conv's sums follow the thread count.
* Once against the JAX package's ``make_spatial_infer_fn`` at 4 shards
  (``method='forward'``: the JAX package's ``infer`` compiles for many
  times as long, and its inverse warp runs whole, as the port's does): ``pred``
  within 1e-4 of its largest magnitude, the slice's tolerance between the
  two packages' convs (``tests/test_torch_port_slice.py``).
* The serving CLI: ``--spatial 2`` gives the one-process labels on the
  decided pixels; ``--mesh 2`` with ``resnet18_nonsyn`` (each BatchStatsNorm
  takes the statistics of the whole micro-batch over the ranks) gives the
  one-process labels on the decided pixels; ``--spatial`` with ``--mesh``
  exits before any rank starts. SegFormer and DeepLab:
  ``test_torch_parallel_spatial_encoders.py``.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.parallel.mesh import make_mesh_spatial, make_spatial_infer_fn
from fovealseg_torch.cli import infer as infer_cli
from fovealseg_torch.models.deform_module import DeformConfig
from fovealseg_torch.parallel import spatial
from fovealseg_torch.parallel.launch import run_workers
from fovealseg_torch.train.checkpoint import from_jax_variables

import torch_parallel_workers as W
from torch_port_zoo import seeded_variables

CFG = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
           arch_encoder="hrnetv2_nodownsp_tiny")
# the dotlist options come last (argparse hands every later argument to them)
TINY = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
        "TPU.compute_dtype", "float32"]
SERVE = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
         "--num-batches", "2"]


def decided(scores: np.ndarray) -> np.ndarray:
    """Where the top-two margin of ``scores`` [..., C] exceeds 1e-4."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 1e-4


def _cli(flags, out, opts=()):
    return infer_cli.main(SERVE + flags + ["--out", out] + TINY + list(opts))


def _cli_scores(opts, batch: int) -> tuple:
    """The serving CLI's frames and the one-process scores of its model
    (seeded from ``TRAIN.seed``), batch by batch: what decides its labels."""
    args, cfg, _ = infer_cli._parse(SERVE + ["--batch", str(batch)] + TINY + opts)
    model = infer_cli.build_model(cfg, torch.device("cpu"))
    scores = []
    for _, x, f in infer_cli.synthetic_batches(args.num_batches, args.canvas, batch):
        with torch.no_grad():
            scores.append(model.infer(torch.from_numpy(x), torch.from_numpy(f))
                          ["pred_sampled"].numpy())
    return np.concatenate(scores)


def _masks(d) -> np.ndarray:
    names = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
    return np.stack([np.load(os.path.join(d, n)) for n in names])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights and frames, the ranks' future and the CLI runs' futures,
    then the one-process references here (oneDNN off)."""
    jm = JaxDeform(config=JaxConfig(**CFG))
    v = seeded_variables(jm, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)), seed=3)
    sd = from_jax_variables(v["params"], v["batch_stats"])
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    f = np.array([[0.5, 0.5], [0.25, 0.75]], np.float32)
    root = tmp_path_factory.mktemp("spatial")
    with ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(run_workers, 4, W.spatial_serve, sd, x, f, CFG, device="cpu",
                            timeout=600, threads=1)
        spatial_cli = pool.submit(_cli, ["--batch", "2", "--spatial", "2"],
                                  str(root / "spatial"))
        nonsyn = pool.submit(_cli, ["--batch", "4", "--mesh", "2"], str(root / "nonsyn"),
                             ["MODEL.saliency_net", "resnet18_nonsyn"])
        # one thread, as each rank: the reference conv's sums follow the thread count
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with torch.backends.mkldnn.flags(enabled=False), torch.no_grad():
                model = W.tiny_model(sd, DeformConfig(**CFG))
                xt, ft = torch.from_numpy(x), torch.from_numpy(f)
                one = {"pred_forward": model(xt, ft)["pred"], **model.infer(xt, ft)}
                one["pred_label"] = model.infer(xt, ft, argmax_labels=True)["pred_label"]
            yield dict(v=v, x=x, f=f, one=one, ranks=ranks, spatial=spatial_cli, nonsyn=nonsyn,
                       root=root)
        finally:
            torch.set_num_threads(prev)


def test_the_tiny_shape_leaves_empty_blocks_at_one_eighth():
    """16 task rows over 4 ranks: 4 rows each at full resolution, the 1/8
    level's 2 rows on ranks 0 and 2 (ranks 1 and 3 hold none), the blocks of
    each level derived from the finest."""
    assert spatial._blocks(16, 4, 16) == ((0, 4), (4, 8), (8, 12), (12, 16))
    assert spatial._blocks(16, 4, 8) == ((0, 2), (2, 4), (4, 6), (6, 8))
    assert spatial._blocks(16, 4, 2) == ((0, 1), (1, 1), (1, 2), (2, 2))
    # the flagship's 1/8 level over 4 ranks: 3, 2, 3, 2 rows
    assert [b - a for a, b in spatial._blocks(80, 4, 10)] == [3, 2, 3, 2]


@pytest.mark.parametrize("world", ["4", "2"])
def test_spatial_forward_and_infer_match_one_process(setup, world):
    one = setup["one"]
    ranks = [r[world] for r in setup["ranks"].result() if world in r]
    assert len(ranks) == int(world)
    ok = decided(one["pred_sampled"].numpy())
    print(f"{world} ranks: {(~ok).sum()} of {ok.size} full-res pixels undecided")
    for r in ranks:
        assert r["exchanges_forward"] > 50  # the trunk's halo exchanges, a mean, a gather
        for key, ref in (("pred_forward", "pred_forward"), ("pred", "pred"),
                         ("pred_sampled", "pred_sampled")):
            got, want = r[key].numpy(), one[ref].numpy()
            assert got.shape == want.shape
            scale = np.abs(want).max()
            loose = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
            print(f"{world} ranks, {key}: largest difference {np.abs(got - want).max():.3g} of "
                  f"{scale:.3g}; {loose.sum()} of {loose.size} past rtol 1e-5 + atol 1e-5")
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_array_equal(r["pred_label"].numpy()[ok], one["pred_label"].numpy()[ok])


def test_spatial_forward_matches_jax_spatial_forward(setup):
    """JAX's ``make_spatial_infer_fn`` at 4 shards against the port's four
    ranks: the warped-domain logits."""
    _, fn = make_spatial_infer_fn(JaxConfig(**CFG), make_mesh_spatial(4), method="forward")
    ref = np.asarray(fn(setup["v"], jnp.asarray(setup["x"]), jnp.asarray(setup["f"])))
    got = setup["ranks"].result()[0]["4"]["pred_forward"].numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))


def test_cli_spatial_gives_the_one_process_labels(setup):
    ranks = setup["spatial"].result()
    assert len(ranks) == 2 and ranks[0]["spatial"] == 2 and ranks[0]["frames"] == 2
    assert ranks[0]["exchanges"] > 0 and ranks[0]["exchanges"] == ranks[1]["exchanges"]
    one = _cli(["--batch", "2"], str(setup["root"] / "one"))
    assert one["frames"] == 2 and one["exchanges"] == 0
    a, b = _masks(setup["root"] / "spatial"), _masks(setup["root"] / "one")
    ok = decided(_cli_scores([], 2))
    print(f"--spatial 2: {(~ok).sum()} of {ok.size} pixels undecided")
    assert a.shape == b.shape == ok.shape
    np.testing.assert_array_equal(a[ok], b[ok])


def test_cli_mesh_with_a_nonsyn_saliency_net(setup):
    """``--mesh 2`` at batch 4: each rank's two frames normalised with the
    statistics of all four, as one process normalises them."""
    opts = ["MODEL.saliency_net", "resnet18_nonsyn"]
    ranks = setup["nonsyn"].result()
    assert len(ranks) == 2 and ranks[0]["frames"] == 4
    _cli(["--batch", "4"], str(setup["root"] / "nonsyn_one"), opts)
    a, b = _masks(setup["root"] / "nonsyn"), _masks(setup["root"] / "nonsyn_one")
    ok = decided(_cli_scores(opts, 4))
    print(f"--mesh 2 resnet18_nonsyn: {(~ok).sum()} of {ok.size} pixels undecided")
    assert a.shape == b.shape == ok.shape
    np.testing.assert_array_equal(a[ok], b[ok])


@pytest.mark.parametrize("flags,opts", [(["--mesh", "2"], [])], ids=["mesh"])
def test_cli_spatial_refusals(flags, opts):
    """Refused before any rank starts."""
    with pytest.raises(SystemExit, match="--spatial"):
        infer_cli.main(SERVE + ["--batch", "2", "--spatial", "2"] + flags + TINY + opts)
