"""Port: W8A8 int8 serving (``TPU.quantize="int8"``) against the JAX package,
on the CPU.

The scheme is ``fovealseg_tpu/models/layers.py``'s: symmetric int8 with
zero-point 0, a per-output-channel weight scale, one dynamic activation
scale per tensor, int32 sums, then ``z * (s_x * s_w)`` in f32, the cast and
the bias, only on the convs the JAX package builds as ``TorchConv`` with at
least 128 input and output channels. On the CPU the port runs the plain
versions of K6-K8 (``fovealseg_torch/ops/quant.py``); the card tests
(``tests/test_torch_port_cuda.py -k quant``) hold the kernels to them.

* ``quantize_kernel``, the activation scale and codes, the int32 sums and
  the conv's output are bit-equal to the JAX functions, run op by op. Under
  ``jax.jit`` XLA on the CPU fuses the f32 multiply and the bias add into
  one FMA, which rounds once: there the f32 output with a bias is shown to
  differ and held within half an ulp of the product plus one ulp of the
  output, the rest bit for bit.
* The set of convs that run int8 in the port's ``infer`` is the JAX
  package's ``quantized_kernel_paths``: ``test_torch_port_quantize_sets.py``
  (a file of its own, so that each file's abstract traces of the full-depth
  encoders and this file's compiles run on separate test workers).
* The slice: ``hrnetv2_nodownsp_tiny`` (the full widths, one module per
  stage) at ``tests/test_quantize.py``'s 16x16 task, weights from a numpy
  seed carried from the JAX model to the port. The JAX side runs its jitted
  W8A8 forward with the hoisted quantization, and its labels through the
  Pallas flood in interpret mode (the TPU's route; on the CPU it would take
  its lax chain, which breaks ties otherwise). The labels agree on >= 99%
  of pixels, the bound of ``test_torch_port_bf16.py``. The logits are held
  at the decoder that makes them (C1 on the same features): within 2e-2 of
  their largest value in bf16, that file's bound, and 1e-4 in f32. Through
  the whole slice an activation that rounds its last bit otherwise in the
  two frameworks can land across a code's rounding boundary, and the moved
  codes spread from conv to conv until two W8A8 forwards differ by the
  quantization noise (``test_slice_int8_labels_agree_with_jax`` gives the
  numbers). The port's int8 labels agree with its float labels on > 95%,
  the bound of ``tests/test_quantize.py``.
* The serving and evaluation CLIs: ``TPU.quantize int8`` serves through the
  int8 path, other values raise, ``--mesh`` and ``--spatial`` refuse it
  before any rank starts, ``TPU.conv_pack`` serves the same labels.
* ``TPU.scoremap_gather_bf16``: ``unwarp_prediction_fast`` bit-equal to the
  JAX function.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import grid as jgrid
from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.models import builder as jbuilder
from fovealseg_tpu.models import layers as jlayers
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.ops.pallas_jfa import nearest_class_pallas, nearest_payload_packed_pallas
from fovealseg_torch.core import unwarp
from fovealseg_torch.models import layers
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.ops import quant
from fovealseg_torch.train.checkpoint import from_jax_variables
from tests.torch_port_zoo import seeded_variables

# tests/test_quantize.py's flagship geometry, the tiny HRNet (full widths)
SLICE = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=9,
             num_class=8, arch_encoder="hrnetv2_nodownsp_tiny")
CLI_FLAGS = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--device", "cpu", "--canvas", "64",
             "--batch", "2", "--num-batches", "1"]
CLI_OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
            "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


# ------------------------------------------------------------ 1. weights


@pytest.mark.parametrize("shape", [(128, 128, 3, 3), (240, 960, 3, 3), (256, 128, 1, 1)])
def test_quantize_kernel_bit_equal_to_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))).astype(np.float32)
    w[3] = 0.0  # an all-zero output channel: scale 1e-12 / 127, codes 0
    ref_q, ref_s = jlayers.quantize_kernel(jnp.asarray(w.transpose(2, 3, 1, 0)))
    q, s = layers.quantize_kernel(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ref_s))
    assert (q[3] == 0).all() and s[3] == np.float32(1e-12) / np.float32(127.0)


# ------------------------------------------------------- 2. the plain conv

# (kernel, stride, padding, cin, cout, dtype, bias): every value of each
# option, the served models' shapes among them (HRNet's branches, C1's cbr
# 960 -> 240 and its class head's stride-4 convs)
CONV_CASES = [
    (3, 1, 1, 128, 128, "float32", False),
    (3, 1, 1, 128, 128, "float32", True),
    (3, 2, 1, 128, 256, "bfloat16", True),
    (1, 1, 0, 256, 256, "float32", True),
    (1, 2, 0, 256, 128, "bfloat16", False),
    (3, 1, 1, 960, 240, "float32", False),
    (3, 1, 1, 960, 240, "bfloat16", True),
    (3, 1, 0, 128, 128, "bfloat16", False),
    (1, 1, 1, 128, 128, "float32", True),
    (3, 4, 1, 960, 512, "float32", True),
    (1, 4, 0, 960, 512, "bfloat16", True),
    (3, 2, 1, 256, 256, "float32", False),
]


def _conv_inputs(k, stride, padding, cin, cout, dtype, bias):
    rng = np.random.default_rng(k * 1000 + cin + cout + stride)
    x = rng.standard_normal((2, cin, 7, 9)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32) if bias else None
    return x, w, b


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "k{}s{}p{}_{}x{}_{}_{}".format(
    *c[:6], "bias" if c[6] else "nobias"))
def test_plain_int8_conv_bit_equal_to_jax(case):
    k, stride, padding, cin, cout, dt, bias = case
    x, w, b = _conv_inputs(*case)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)

    # the JAX package: TorchConv's W8A8 branch with the hoisted weights, op by op
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    kernel = jnp.asarray(w.transpose(2, 3, 1, 0))
    w_q, s_w = jlayers.quantize_kernel(kernel)
    bj = None if b is None else jnp.asarray(b).astype(jdt)

    def jax_conv(xj, kernel, w_q, s_w, bj):
        y = jlayers._int8_conv(xj, kernel.astype(jdt), stride, padding, w_q=w_q, s_w=s_w)
        return y if bj is None else y + bj

    ref = np.asarray(jax_conv(xj, kernel, w_q, s_w, bj))
    xf = xj.astype(jnp.float32)  # _int8_conv's codes and int32 sums, its own lines
    ref_sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    ref_xq = jnp.round(xf / ref_sx).astype(jnp.int8)
    dn = jax.lax.conv_dimension_numbers(xj.shape, kernel.shape, ("NHWC", "HWIO", "NHWC"))
    ref_z = jax.lax.conv_general_dilated(ref_xq, w_q, (stride, stride),
                                         ((padding, padding), (padding, padding)),
                                         dimension_numbers=dn,
                                         preferred_element_type=jnp.int32)

    # the port: the plain versions, and the wrappers (CPU kernels of the operators)
    xt = torch.from_numpy(x).to(tdt)
    codes, scale = layers.quantize_kernel(torch.from_numpy(w))
    wq = codes.permute(0, 2, 3, 1).contiguous()
    bt = None if b is None else torch.from_numpy(b).to(tdt)
    s_x = quant.absmax_scale_plain(xt)
    xq = quant.quantize_act_plain(xt, s_x)
    z = quant.int8_sums_plain(xq, wq, stride, padding)
    out = quant.int8_conv2d_plain(xq, wq, s_x, scale, bt, stride, padding, tdt)
    np.testing.assert_array_equal(_torch_bits(s_x), _bits(ref_sx))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref_z).transpose(0, 3, 1, 2))
    assert out.dtype == tdt
    np.testing.assert_array_equal(_torch_bits(out), _bits(ref).transpose(0, 3, 1, 2))

    calls = [f.plain_calls for f in (quant.absmax_scale, quant.quantize_act, quant.int8_conv2d)]
    got = quant.w8a8_conv2d(xt, wq, scale, bt, stride, padding)
    assert [f.plain_calls for f in (quant.absmax_scale, quant.quantize_act,
                                    quant.int8_conv2d)] == [c + 1 for c in calls]
    np.testing.assert_array_equal(_torch_bits(got), _torch_bits(out))

    # jitted, as the JAX CLIs run it: XLA contracts the f32 multiply and the
    # bias add into one FMA (one rounding where the ops round twice)
    jitted = np.asarray(jax.jit(jax_conv)(xj, kernel, w_q, s_w, bj)).transpose(0, 3, 1, 2)
    got32 = out.float().numpy()
    if dt == "float32" and bias:
        # the FMA skips the product's rounding (at most half its ulp) and
        # rounds the sum once (at most one ulp of the output apart)
        assert (jitted != got32).any(), "XLA no longer contracts: hold this case bit for bit"
        product = quant.dequantize_plain(z, s_x, scale, None, tdt).numpy()
        bound = 0.5 * np.spacing(np.abs(product)) + np.spacing(np.abs(got32))
        assert (np.abs(jitted - got32) <= bound).all()
    else:
        np.testing.assert_array_equal(_bits(jitted), _torch_bits(out))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    xq = torch.zeros((1, 8, 8, 128), dtype=torch.int8)
    wq = torch.zeros((128, 3, 3, 128), dtype=torch.int8)
    s, sw = torch.ones(()), torch.ones(128)
    for bad in (dict(stride=3), dict(padding=2), dict(wq=torch.zeros((128, 5, 5, 128),
                                                                     dtype=torch.int8)),
                dict(xq=torch.zeros((1, 8, 8, 120), dtype=torch.int8),
                     wq=torch.zeros((128, 3, 3, 120), dtype=torch.int8)),
                dict(dtype=torch.float16), dict(bias=torch.zeros(128))):
        args = {**dict(xq=xq, wq=wq, s_x=s, w_scale=sw, bias=None, stride=1, padding=1,
                       dtype=torch.bfloat16), **bad}
        with pytest.raises(ValueError):
            quant.int8_conv2d(args["xq"], args["wq"], args["s_x"], args["w_scale"],
                              args["bias"], args["stride"], args["padding"], args["dtype"])
    with pytest.raises(ValueError):
        quant.absmax_scale(torch.zeros((2, 4, 3, 3), dtype=torch.float16))
    with pytest.raises(ValueError):
        quant.quantize_act(torch.zeros((2, 6, 3, 3)), torch.ones(()))


# ----------------------------------------------------------- 4. the slice


def _tpu_route(valid, payload, num_iters=None, rounds=None, cls_bits=None, pay_bits=None):
    """The JAX package's flood as it runs on a TPU ('relpay'), in interpret
    mode (the port follows the Pallas kernel's ties)."""
    return nearest_payload_packed_pallas(valid, payload, pay_bits, num_iters, interpret=True,
                                         rounds=rounds)


def _jax_labels(pred, grid, seg_hw):
    """``unwarp_argmax_scatter``'s composition through the Pallas flood."""
    b, th, tw, c = pred.shape
    m = 1 << max(1, (c - 1).bit_length())
    cls2 = jnp.argmax(junwarp.halfpixel_avg(jnp.asarray(pred)), axis=-1).astype(jnp.int32)
    combined = jnp.arange(th * tw, dtype=jnp.int32)[None] * m + cls2.reshape(b, th * tw)
    canvas = jgrid.landing_scatter_max(jnp.asarray(grid), seg_hw, combined)
    valid = canvas >= 0
    return np.asarray(nearest_class_pallas(valid, jnp.where(valid, canvas % m, 0),
                                           cls_bits=m.bit_length() - 1, interpret=True,
                                           rounds=junwarp.jfa_rounds_from_grid(
                                               jnp.asarray(grid), seg_hw)))


@pytest.fixture(scope="module")
def slice_runs():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.3, 0.7, (2, 2)).astype(np.float32)
    # one abstract init of the W8A8 ``infer`` with the publish flag on (as
    # ``quantized_kernel_paths`` runs it): the variables' shapes and the quant paths
    jm = JaxDeform(config=JaxConfig(**SLICE))
    with jlayers.quantization(), jlayers._quant_publish():
        shapes = jax.eval_shape(lambda x, f: jm.init(jax.random.PRNGKey(0), x, f,
                                                     argmax_labels=True, method=JaxDeform.infer),
                                jnp.asarray(x), jnp.asarray(f))
    paths = {p[:-1] for p in flax.traverse_util.flatten_dict(shapes.pop("quant"))}
    variables = seeded_variables(jm, seed=17, shapes=shapes)
    quant_vars = jlayers.quantize_params(variables["params"], paths)
    state = from_jax_variables(variables["params"], variables["batch_stats"])
    runs = {}
    for dt in ("float32", "bfloat16"):
        jm = JaxDeform(config=JaxConfig(**SLICE), dtype=getattr(jnp, dt))

        def forward(v, q, x, f, jm=jm):
            with jlayers.quantization():
                return jm.apply({**v, "quant": q}, x, f, train=False)

        ref = jax.jit(forward)(variables, quant_vars, jnp.asarray(x), jnp.asarray(f))
        ref = {k: np.asarray(jnp.asarray(ref[k], jnp.float32)) for k in ("pred", "grid")}
        ref["pred_label"] = _jax_labels(ref["pred"], ref["grid"], (64, 64))
        model = DeformSegmentation(DeformConfig(**SLICE), dtype=getattr(torch, dt), device="cpu")
        model.load_state_dict(state, strict=True)
        args = torch.from_numpy(x), torch.from_numpy(f)
        flt = model.infer(*args, argmax_labels=True)
        n = layers.quantize_model(model)
        calls = quant.int8_conv2d.plain_calls
        q = model.infer(*args, argmax_labels=True)
        assert quant.int8_conv2d.plain_calls - calls == n == len(paths)
        runs[dt] = ref, {k: t.float().numpy() for k, t in q.items()}, flt["pred_label"].numpy()
    return runs


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_slice_int8_labels_agree_with_jax(slice_runs, dt):
    """The served W8A8 labels. The logits of the whole slice are held at the
    decoder below: through the ~30 quantized convs of the HRNet a last-bit
    difference of one activation moves one code, which moves the next
    conv's inputs and codes, until two W8A8 forwards differ by the
    quantization noise itself (measured on this slice: the port 3.9% of the
    largest logit from the JAX package, the JAX package's own eager and
    jitted forwards 4.3% from each other; the float forwards 1.7e-6)."""
    ref, got, _ = slice_runs[dt]
    assert got["pred_label"].shape == ref["pred_label"].shape == (2, 64, 64)
    assert (got["pred_label"] == ref["pred_label"]).mean() >= 0.99


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_slice_int8_labels_agree_with_float(slice_runs, dt):
    _, got, float_labels = slice_runs[dt]
    assert (got["pred_label"] == float_labels).mean() > 0.95


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decoder_int8_logits_within_tolerance_of_jax(dt):
    """C1 (its 7 quantized convs: ``cbr`` and the class head) on the same
    960-channel features, W8A8 in both frameworks with the hoisted weights
    (the JAX decoder op by op):
    the logits within 2e-2 of their largest value in bf16 (the bf16 slice's
    bound: the float bf16 decoders differ by 0.9% there), 1e-4 in f32
    (measured 3.4e-7: a code moves only where an activation rounds across a
    code boundary)."""
    from fovealseg_torch.models.c1 import C1

    rng = np.random.default_rng(4)
    feats = np.maximum(rng.standard_normal((2, 16, 16, 960)), 0).astype(np.float32)
    jd = jbuilder.build_decoder("c1", 960, 8, dtype=getattr(jnp, dt))
    v = seeded_variables(jd, jnp.asarray(feats), seed=3)
    paths = jlayers.quantized_kernel_paths(jd, v, jnp.asarray(feats))

    with jlayers.quantization():  # op by op: the file compiles one JAX model, the slice's
        ref = jd.apply({**v, "quant": jlayers.quantize_params(v["params"], paths)},
                       jnp.asarray(feats))
    ref = np.asarray(ref.astype(jnp.float32))
    port = C1(8, 960, dtype=getattr(torch, dt)).eval()
    port.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], module=True),
                         strict=True)
    assert layers.quantize_model(port) == len(paths) == 7
    with torch.no_grad():
        got = port(torch.from_numpy(feats.transpose(0, 3, 1, 2).copy())).float().numpy()
    err = np.abs(got.transpose(0, 2, 3, 1) - ref).max() / np.abs(ref).max()
    assert err <= (1e-4 if dt == "float32" else 2e-2), err


# --------------------------------------------------------------- 5. CLIs


def _serve(tmp_path, name, *opts):
    """The serving CLI on the CPU; returns (summary, masks, the logits of
    each call, the int8 conv's plain calls during it)."""
    from fovealseg_torch.cli import infer as cli

    logits = []
    real = DeformSegmentation.infer

    def infer(self, *a, **k):
        out = real(self, *a, **k)
        logits.append(out["pred"].float().numpy())
        return out

    out_dir = tmp_path / name
    calls = quant.int8_conv2d.plain_calls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeformSegmentation, "infer", infer)
        summary = cli.main(CLI_FLAGS + ["--out", str(out_dir)] + CLI_OPTS + list(opts))
    masks = np.stack([np.load(p) for p in sorted(out_dir.glob("*.mask.npy"))])
    return summary, masks, logits, quant.int8_conv2d.plain_calls - calls


def test_cli_infer_serves_int8(tmp_path):
    """``TPU.quantize int8`` serves W8A8: every quantized conv runs the int8
    path once per micro-batch, and the served logits are not the float ones
    (the CLI once read neither option and served float)."""
    summary, masks, logits, calls = _serve(tmp_path, "int8", "TPU.quantize", "int8")
    _, float_masks, float_logits, float_calls = _serve(tmp_path, "float")
    assert summary["quantize"] == "int8" and summary["quantized_convs"] > 0
    assert calls == summary["quantized_convs"] and float_calls == 0
    assert masks.shape == float_masks.shape == (2, 64, 64)
    assert not np.array_equal(logits[0], float_logits[0])
    assert np.abs(logits[0] - float_logits[0]).max() <= 0.1 * np.abs(float_logits[0]).max()
    assert (masks == float_masks).mean() > 0.95


def test_cli_infer_conv_pack_serves_the_same_labels(tmp_path):
    _, masks, logits, _ = _serve(tmp_path, "pack", "TPU.conv_pack", "True")
    _, plain_masks, plain_logits, _ = _serve(tmp_path, "plain")
    np.testing.assert_array_equal(masks, plain_masks)
    np.testing.assert_array_equal(logits[0], plain_logits[0])


def test_cli_infer_refuses_an_unknown_quantize(tmp_path):
    from fovealseg_torch.cli import infer as cli

    with pytest.raises(ValueError, match="int4"):
        cli.main(CLI_FLAGS + CLI_OPTS + ["TPU.quantize", "int4"])


@pytest.mark.parametrize("ranks", [["--mesh", "2"], ["--spatial", "2"]])
def test_cli_infer_int8_refuses_ranks_before_they_start(ranks):
    from fovealseg_torch.cli import infer as cli
    from fovealseg_torch.parallel import launch

    def started(*a, **k):
        raise AssertionError("a rank was started")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch, "run_workers", started)
        with pytest.raises(SystemExit, match="TPU.quantize"):
            cli.main(CLI_FLAGS + ranks + CLI_OPTS + ["TPU.quantize", "int8"])


# ------------------------------------------- 6. TPU.scoremap_gather_bf16


def test_scoremap_gather_bf16_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    pred = rng.standard_normal((2, 16, 16, 51)).astype(np.float32)
    base = np.stack(np.meshgrid(np.linspace(-1, 1, 16), np.linspace(-1, 1, 16),
                                indexing="xy"), -1)
    grid = np.clip(base[None] * np.array([0.8, 0.7]) + 0.05 * rng.standard_normal(
        (2, 16, 16, 2)), -1, 1).astype(np.float32)
    seg_hw = (64, 64)
    task_idx, valid = jgrid.inverse_grid_index(jnp.asarray(grid), seg_hw)
    rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(grid), seg_hw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(junwarp, "_nearest_payload", _tpu_route)
        ref = junwarp.unwarp_prediction_fast(jnp.asarray(pred), task_idx, valid, rounds=rounds,
                                             gather_bf16=True)
    args = (torch.from_numpy(pred), torch.from_numpy(np.array(task_idx)),
            torch.from_numpy(np.array(valid)), None, torch.from_numpy(np.array(rounds)))
    got = unwarp.unwarp_prediction_fast(*args, gather_bf16=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_torch_bits(got), _bits(ref))
    exact = unwarp.unwarp_prediction_fast(*args)
    assert not torch.equal(got, exact)  # the rows were rounded
    assert torch.equal(got, exact.to(torch.bfloat16).float())
    # the 'windowed' gather ignores it, as the JAX package's Pallas path does
    assert torch.equal(unwarp.unwarp_prediction_fast(*args, gather_bf16=True,
                                                     gather_impl="windowed"), exact)
