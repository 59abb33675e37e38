"""Port: the four ResNetZoom saliency nets and the builders against the JAX
package (``fovealseg_tpu/models/saliency.py``), on the CPU.

Each net runs on a seeded 5-channel input with the same seeded weights on
both sides (the JAX package's torch export, loaded ``strict=True``):
``resnet18_stride1`` at 16x16 (a 16x16 map out), the three stride-16 nets
at 32x32 (a 2x2 map out). At a 16x16 input the stride-16 nets end on a 1x1
map, and a train-mode or ``_nonsyn`` BN then normalises each channel over
the batch's 2 values: measured, the f32 output of either framework is then
7-12% from its float64 forward, so no f32 tolerance holds there; at 2x2
both are within 1e-5 of it. The ``_nonsyn`` nets run at batch 2 and 3.
Each case holds (``rel_err``: max abs difference over the largest
magnitude):

* the port against the JAX package: 1e-5 in float32 (measured 9.8e-7 to
  6.2e-6), 6e-2 in bfloat16 (measured 1e-2 to 5e-2: every BN renormalises
  the rounded bf16 conv outputs over a few values per channel, and the two
  frameworks round their sums differently; each is 1-4% from float64);
* the port no farther from the float64 forward of the same weights than
  twice the JAX package's distance, plus 1e-6 in f32 and 4e-3 in bf16
  (measured ratios 0.9 to 1.7);
* after a train-mode forward of a net with running statistics, those
  statistics within 1e-4 in f32 and 2e-2 in bf16.

Also: ``BatchStatsNorm`` against the JAX ``_BatchStatsNorm``, the
dependence of a ``_nonsyn`` net's output on the other frames of its batch,
the key sets through ``jax.eval_shape`` and the builders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.builder import build_net_compress as jax_build_net_compress
from fovealseg_tpu.models.saliency import _BatchStatsNorm, build_saliency
from fovealseg_torch.models import builder, layers
from fovealseg_torch.models.saliency import ZOOM_NETS, CompressNet, ResNetZoom
from tests.torch_port_zoo import (
    assert_as_accurate,
    jax_forward,
    key_coverage,
    port_forward,
    port_forward64,
    port_state,
    rel_err,
    running_stats_err,
    seeded_variables,
    two_threads_no_dropout,  # noqa: F401
    variable_shapes,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 6e-2)}
FLOOR = {"float32": 1e-6, "bfloat16": 4e-3}
CASES = [(name, b) for name in ZOOM_NETS for b in ((2, 3) if name.endswith("_nonsyn") else (2,))]


@pytest.fixture(autouse=True, scope="module")
def _setup(two_threads_no_dropout):  # noqa: F811
    yield


def _input(name, batch):
    hw = 16 if name == "resnet18_stride1" else 32
    return np.random.default_rng(7 + batch).normal(size=(batch, hw, hw, 5)).astype(np.float32)


_VARS = {}


def _weights(name, x):
    if name not in _VARS:
        v = seeded_variables(build_saliency(name), jnp.asarray(x), seed=8)
        _VARS[name] = v, port_state(v, "localization")
    return _VARS[name]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,batch", CASES)
def test_zoom_net_matches_jax(name, batch, dtype, train):
    x = _input(name, batch)
    v, sd = _weights(name, x)
    jdt, tdt, tol = DTYPES[dtype]
    ref, stats = jax_forward(build_saliency(name, dtype=jdt), v, x, train)
    layers_, stride1, nonsyn = ZOOM_NETS[name]
    net = ResNetZoom(layers_, stride1, nonsyn, tdt)
    net.load_state_dict(sd, strict=True)
    got = port_forward(net, x, train)
    stride = 1 if stride1 else 16
    assert got.shape == (batch, x.shape[1] // stride, x.shape[2] // stride, 256)
    assert_as_accurate(got, ref, port_forward64(net, x, train), tol, FLOOR[dtype])
    if train and not nonsyn:
        assert running_stats_err(net, stats, "localization") <= (1e-4 if dtype == "float32"
                                                                  else 2e-2)
    if nonsyn:
        assert stats is None and not any("running" in k for k in net.state_dict())


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_stats_norm_matches_jax(dtype):
    """``BatchStatsNorm`` is the JAX ``_BatchStatsNorm``: E[x^2] - mean^2 in
    f32 over the batch and the map, in eval as in train; on inputs with mean
    2 it agrees within 1e-5 in f32 and one bf16 ulp (2^-7) in bf16."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(11)
    x = (2.0 + rng.normal(size=(3, 5, 6, 8))).astype(np.float32)  # NHWC
    scale = (1 + 0.1 * rng.normal(size=8)).astype(np.float32)
    bias = (0.1 * rng.normal(size=8)).astype(np.float32)
    ref = _BatchStatsNorm(dtype=jdt).apply({"params": {"scale": scale, "bias": bias}},
                                           jnp.asarray(x, jdt))
    norm = layers.BatchStatsNorm(8, tdt)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    for mode in (False, True):
        norm.train(mode)
        with torch.no_grad():
            got = norm(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)


def test_nonsyn_output_depends_on_the_batch():
    """A ``_nonsyn`` net serves each frame with its batch's statistics, as the
    reference does: frame 0 alone and frame 0 beside two others differ, on
    both sides alike."""
    x = _input("resnet10_nonsyn", 3)
    v, sd = _weights("resnet10_nonsyn", x)
    net = ResNetZoom(*ZOOM_NETS["resnet10_nonsyn"])
    net.load_state_dict(sd, strict=True)
    alone, together = port_forward(net, x[:1], False)[0], port_forward(net, x, False)[0]
    j_alone = jax_forward(build_saliency("resnet10_nonsyn"), v, x[:1], False)[0][0]
    j_together = jax_forward(build_saliency("resnet10_nonsyn"), v, x, False)[0][0]
    assert rel_err(alone, together) > 1e-2
    assert rel_err(alone, j_alone) <= 1e-4 and rel_err(together, j_together) <= 1e-4


@pytest.mark.parametrize("name", ["fovsimple", *ZOOM_NETS])
def test_saliency_and_compress_keys_match_the_jax_tree(name):
    """Each saliency net and its compress net (24 input channels for
    ``fovsimple``, 256 otherwise): every port key is one JAX leaf with the
    transposed shape, and the reverse (``_nonsyn``: no running statistics)."""
    x = jnp.zeros((1, 32, 32, 5))
    key_coverage(builder.build_net_saliency(name), variable_shapes(build_saliency(name), x))
    compress = builder.build_net_compress(name)
    c = 24 if name == "fovsimple" else 256
    assert isinstance(compress, CompressNet) and compress.conv_last.in_channels == c
    key_coverage(compress, variable_shapes(jax_build_net_compress(name), jnp.zeros((1, 4, 4, c))))


def test_builders_name_what_is_ported():
    """The four ResNetZoom names, ``segformer`` and ``deeplab`` build; any
    other name raises and names the ported ones."""
    for name in ZOOM_NETS:
        assert isinstance(builder.build_net_saliency(name), ResNetZoom)
    with torch.device("meta"):
        for arch in ("segformer", "deeplab", "SegFormer"):
            builder.build_encoder(arch, 1024)
    for bad in ("resnet34", "fovsimple2"):
        with pytest.raises(ValueError, match="resnet18_stride1"):
            builder.build_net_saliency(bad)
    for bad in ("segformer_tiny", "hrnetv2", "mobilenet"):
        with pytest.raises(ValueError, match="deeplab"):
            builder.build_encoder(bad)
