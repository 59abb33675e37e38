"""Port: the DeepLabV3-ResNet101 encoder against the JAX package
(``fovealseg_tpu/models/deeplab.py``), on the CPU.

The encoder runs with ``layers=(1, 1, 1, 1)`` (one Bottleneck per layer,
the full stem, dilations, ASPP and tail) on a seeded 2x32x32 input (a 4x4
map at output stride 8), with the same seeded weights on both sides (the
JAX package's torch export, loaded ``strict=True``) and dropout off.
Each case holds (``rel_err``: max abs difference over the largest
magnitude):

* the port against the JAX package: float32 eval 1e-5 (measured 1.1e-6);
  float32 train 2e-4 (measured 9.5e-5: here the JAX package is itself
  9.3e-5 from the float64 forward, the port 7e-6, because train-mode BN
  over the 4x4 map takes flax's variance E[x^2] - mean^2, which cancels
  bits); bfloat16 eval 3e-2 (measured 9e-3), train 0.15 (measured 0.11:
  train-mode BN over 32 values per channel renormalises each rounded bf16
  conv output, and the two frameworks round their sums differently; each
  is 6-8% from float64);
* the port no farther from the float64 forward of the same weights than
  twice the JAX package's distance, plus 1e-6 in f32 and 4e-3 in bf16;
* the BN running statistics after one train-mode forward: within 1e-4 in
  f32, 5e-2 in bf16 (measured 2.8e-2: the batch statistics of conv outputs
  that each framework rounded to bf16 in its own way).

The full ResNet-101 tree's keys are held to the JAX tree through
``jax.eval_shape`` (no XLA compile).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.deeplab import DeepLabEncoder as JaxDeepLab
from fovealseg_torch.models.builder import build_encoder
from fovealseg_torch.models.deeplab import RESNET101_LAYERS, DeepLabEncoder
from tests.torch_port_zoo import (
    assert_as_accurate,
    cut_encoders,
    jax_forward,
    key_coverage,
    port_forward,
    port_forward64,
    port_state,
    running_stats_err,
    seeded_variables,
    train_step_update_errors,
    two_threads_no_dropout,  # noqa: F401
    variable_shapes,
)

LAYERS = (1, 1, 1, 1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {("float32", False): 1e-5, ("float32", True): 2e-4,
       ("bfloat16", False): 3e-2, ("bfloat16", True): 0.15}
FLOOR = {"float32": 1e-6, "bfloat16": 4e-3}


@pytest.fixture(autouse=True, scope="module")
def _setup(two_threads_no_dropout):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def tiny():
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    v = seeded_variables(JaxDeepLab(layers=LAYERS), jnp.asarray(x), seed=6)
    return x, v, port_state(v)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_encoder_matches_jax(tiny, dtype, train):
    x, v, sd = tiny
    jdt, tdt = DTYPES[dtype]
    ref, stats = jax_forward(JaxDeepLab(layers=LAYERS, dtype=jdt), v, x, train)
    enc = DeepLabEncoder(dtype=tdt, layers=LAYERS)
    enc.load_state_dict(sd, strict=True)
    got = port_forward(enc, x, train)
    assert got.shape == (2, 32, 32, 960)
    assert_as_accurate(got, ref, port_forward64(enc, x, train), TOL[dtype, train], FLOOR[dtype])
    if train:
        assert running_stats_err(enc, stats) <= (1e-4 if dtype == "float32" else 5e-2)


def test_r101_keys_match_the_jax_tree():
    """The full ResNet-101 (3/4/23/3 Bottlenecks), ASPP and tail: every port
    key is one JAX leaf with the transposed shape, and the reverse."""
    shapes = variable_shapes(JaxDeepLab(), jnp.zeros((1, 16, 16, 3)))
    with torch.device("meta"):
        enc = build_encoder("deeplab", 960)
    assert isinstance(enc, DeepLabEncoder)
    key_coverage(enc, shapes)
    bb = enc.deeplab.backbone
    assert tuple(len(getattr(bb, f"layer{i}")) for i in range(1, 5)) == RESNET101_LAYERS


def test_output_stride_8_dilations_and_aspp_rates():
    """torchvision's ``replace_stride_with_dilation=[False, True, True]``: the
    first block of layer3 keeps dilation 1 and strides nothing, the rest of
    layer3 dilate by 2, layer4's first block by 2 and the rest by 4; the ASPP
    branches at rates 12/24/36 pad by the rate."""
    with torch.device("meta"):
        enc = DeepLabEncoder()
    bb = enc.deeplab.backbone
    conv2 = [[(b.conv2.stride[0], b.conv2.dilation[0], b.conv2.padding[0])
              for b in getattr(bb, f"layer{i}")] for i in range(1, 5)]
    assert conv2[0] == [(1, 1, 1)] * 3
    assert conv2[1] == [(2, 1, 1)] + [(1, 1, 1)] * 3
    assert conv2[2] == [(1, 1, 1)] + [(1, 2, 2)] * 22
    assert conv2[3] == [(1, 2, 2)] + [(1, 4, 4)] * 2
    aspp = enc.deeplab.classifier[0]
    assert [(c[0].dilation[0], c[0].padding[0]) for c in aspp.convs[1:4]] == [(12, 12), (24, 24),
                                                                              (36, 36)]
    assert aspp.project[3].p == 0.5


def test_output_is_resized_to_the_input():
    """A 3x40x56 input (a 5x7 map at output stride 8) comes out at 40x56
    with 960 channels, in the compute dtype."""
    enc = DeepLabEncoder(dtype=torch.bfloat16, layers=LAYERS).eval()
    with torch.no_grad():
        (y,) = enc(torch.zeros(1, 3, 40, 56))
    assert y.shape == (1, 960, 40, 56) and y.dtype == torch.bfloat16


def test_train_step_matches_jax():
    """One SGD train step of the tiny ``DeformSegmentation`` with this
    encoder (``tests/torch_port_zoo.py::train_step_update_errors``: dropout
    off, uniform 'BI' so that the warped image is bit-equal, all four groups
    training): the loss within 1e-4, each group's update within 5e-2 of its
    norm (measured: 2.4e-2 at most, the decoder, whose train-mode BN sees
    the encoder's last bits), the BN statistics' update within 1e-3."""
    with cut_encoders():
        loss, jax_loss, errs = train_step_update_errors("deeplab")
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss)
    for (group, stats), err in errs.items():
        assert err <= (1e-3 if stats else 5e-2), (group, stats, err)
