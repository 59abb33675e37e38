"""Port: the SegFormer (MiT-B5) encoder and its layers against the JAX package
(``fovealseg_tpu/models/segformer.py``), on the CPU.

The encoder runs at ``TINY_MIT`` (``tests/test_encoders.py``: depths 1/1/1/1,
widths 8/16/24/32, the B5 strides, patch sizes and reduction ratios) on a
seeded 2x16x16 input, with the same seeded weights on both sides (the JAX
package's torch export, loaded ``strict=True``), drop path 0 and dropout
off. Each case holds two things (``rel_err``: max abs difference over the
largest magnitude):

* the port against the JAX package: 1e-5 in float32, eval and train
  (measured 9.5e-7; the two frameworks sum the matrix products and convs in
  another order), 3e-2 in bfloat16 (measured 1.9e-2, about five bf16 ulps
  at the output's scale: each framework rounds its bf16 products after its
  own order of summation, and five LayerNorms per block renormalise them);
* the port no farther from the float64 forward of the same weights than
  twice the JAX package's distance, plus 1e-6 in f32 and 4e-3 in bf16
  (measured: f32 9.3e-7 against 8.1e-7, bf16 1.8e-2 against 1.7e-2).

``LayerNorm`` and ``gelu`` are held to flax's alone; the full B5 tree's keys
to the JAX tree through ``jax.eval_shape`` (no XLA compile).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.segformer import SegFormerEncoder as JaxSegFormer
from fovealseg_torch.models import layers
from fovealseg_torch.models.builder import build_encoder
from fovealseg_torch.models.segformer import B5, SegFormerEncoder
from tests.test_encoders import TINY_MIT
from tests.torch_port_zoo import (
    assert_as_accurate,
    cut_encoders,
    jax_forward,
    key_coverage,
    port_forward,
    port_forward64,
    port_state,
    seeded_variables,
    train_step_update_errors,
    two_threads_no_dropout,  # noqa: F401
    variable_shapes,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
FLOOR = {"float32": 1e-6, "bfloat16": 4e-3}


@pytest.fixture(autouse=True, scope="module")
def _setup(two_threads_no_dropout):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def tiny():
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32)
    v = seeded_variables(JaxSegFormer(cfg=TINY_MIT, drop_path_rate=0.0), jnp.asarray(x), seed=4)
    return x, v, port_state(v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_flax(dtype):
    """flax ``LayerNorm(epsilon=1e-6)``: statistics in f32 (E[x^2] - mean^2),
    the result cast to the compute dtype. On inputs with mean 3 (where the
    fast variance cancels bits) the port is within 2e-5 in f32 (XLA sums
    E[x^2] in another order; measured 8.8e-6) and bit-equal in bf16."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = (3.0 + rng.normal(size=(2, 37, 24))).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=24)).astype(np.float32)
    bias = (0.1 * rng.normal(size=24)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    ref = fnn.LayerNorm(epsilon=1e-6, dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, xj)
    ln = layers.LayerNorm(24, dtype=tdt)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_is_flax_tanh_gelu(dtype):
    """flax ``nn.gelu`` is the tanh approximation; the port's ``gelu`` agrees
    within one ulp of the compute dtype (f32: 1e-6 relative, bf16: 2^-7;
    measured in bf16: 4 of 1001 values one ulp apart)."""
    jdt, tdt, _ = DTYPES[dtype]
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x, jdt)), np.float32)
    got = layers.gelu(torch.from_numpy(x).to(tdt)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - np.asarray(fnn.gelu(jnp.asarray(x)))).max() > 1e-4  # not HF's erf GELU


def test_drop_path_keeps_or_drops_whole_samples():
    """One Bernoulli draw per sample from the dropout generator: each sample
    is 0 or x / keep throughout, the draw repeats under one seed, eval is the
    identity and a train-mode call without a generator raises."""
    dp = layers.DropPath(0.5)
    x = torch.rand(64, 7, 5) + 0.5
    dp.train()
    outs = []
    for _ in range(2):
        with layers.dropout_generator(torch.Generator().manual_seed(9)):
            outs.append(dp(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    y = outs[0]
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | (~kept).all(1)).all())  # per sample, all or nothing
    assert 0 < int(kept.all(1).sum()) < 64
    torch.testing.assert_close(y[kept.all(1)], x[kept.all(1)] / 0.5, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        dp(x)
    dp.eval()
    assert dp(x) is x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_encoder_matches_jax(tiny, dtype, train):
    x, v, sd = tiny
    jdt, tdt, tol = DTYPES[dtype]
    ref, _ = jax_forward(JaxSegFormer(cfg=TINY_MIT, drop_path_rate=0.0, dtype=jdt), v, x, train)
    enc = SegFormerEncoder(TINY_MIT, drop_path_rate=0.0, dtype=tdt)
    enc.load_state_dict(sd, strict=True)
    got = port_forward(enc, x, train)
    assert got.shape == (2, 16, 16, sum(TINY_MIT["hidden_sizes"]))
    assert_as_accurate(got, ref, port_forward64(enc, x, train), tol, FLOOR[dtype])


def test_b5_keys_match_the_jax_tree():
    """The full B5 (52 blocks): every port key is one JAX leaf with the
    transposed shape and the reverse; 1024 output channels; drop path
    rates 0 .. 0.1 linear over the blocks."""
    shapes = variable_shapes(JaxSegFormer(), jnp.zeros((1, 8, 8, 3)))
    with torch.device("meta"):
        enc = build_encoder("segformer", 1024)
    assert isinstance(enc, SegFormerEncoder) and enc.cfg == B5
    key_coverage(enc, shapes)
    blocks = [b for stage in enc.segformer.encoder.block for b in stage]
    assert len(blocks) == 52
    rates = [b.drop_path.p for b in blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)
    assert np.allclose(np.diff(rates), 0.1 / 51)
    assert sum(B5["hidden_sizes"]) == 1024


def test_init_weights_follows_the_jax_initializers():
    """``init_weights``: xavier-uniform Dense, Kaiming-normal convs (the
    depthwise conv's fan-in is 9), zero biases, LayerNorm ones and zeros."""
    enc = layers.init_weights(SegFormerEncoder(TINY_MIT), torch.Generator().manual_seed(0))
    blk = enc.segformer.encoder.block[0][0]
    q = getattr(blk.attention, "self").query.weight
    limit = float(np.sqrt(6.0 / (q.shape[0] + q.shape[1])))
    top = float(q.detach().abs().max())
    assert 0.5 * limit < top <= limit
    dw = blk.mlp.dwconv.dwconv
    assert dw.groups == dw.in_channels == 32 and dw.weight.shape == (32, 1, 3, 3)
    for m in enc.modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None:
            assert bool((m.bias == 0).all())


def test_train_step_matches_jax():
    """One SGD train step of the tiny ``DeformSegmentation`` with this
    encoder (``tests/torch_port_zoo.py::train_step_update_errors``: dropout
    and drop path off, uniform 'BI' so that the warped image is bit-equal,
    all four groups training): the loss within 1e-4, each group's update
    within 5e-2 of its norm (measured: 1.7e-3 at most, the saliency group),
    the BN statistics' update within 1e-3."""
    with cut_encoders():
        loss, jax_loss, errs = train_step_update_errors("segformer")
    assert abs(loss - jax_loss) <= 1e-4 * abs(jax_loss)
    for (group, stats), err in errs.items():
        assert err <= (1e-3 if stats else 5e-2), (group, stats, err)
