"""Port: the plain-segmentation zoo against the JAX package, f32 on the CPU.

The backbones (``models/backbones.py``), the legacy decoders
(``models/legacy_decoders.py``) and ``SegHRNet`` (``models/seg_hrnet.py``),
each on a numpy-seeded input with the JAX module's seeded variables carried
over by ``from_jax_variables(..., module=True)`` and loaded ``strict=True``.
Deep nets run at a cut depth (the JAX side compiles one small program per
case); every registry name is held at its full depth by key coverage through
``jax.eval_shape``. Tolerances are relative to the output's largest
magnitude (``rel_err``) and stated per test: XLA's and oneDNN's f32 convs
sum in different orders, so each conv layer adds a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models import backbones as jb
from fovealseg_tpu.models import legacy_decoders as jd
from fovealseg_tpu.models import seg_hrnet as js
from fovealseg_tpu.models.segmentation_module import deep_sup_loss as jax_deep_sup_loss
from fovealseg_torch.models import backbones as pb
from fovealseg_torch.models import legacy_decoders as pd
from fovealseg_torch.models import seg_hrnet as ps
from fovealseg_torch.models.segmentation_module import deep_sup_loss
from fovealseg_torch.train.checkpoint import from_jax_variables
from tests.torch_port_zoo import key_coverage, rel_err, seeded_variables, variable_shapes


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carry(jax_module, port_module, *args, seed=0, **kwargs):
    """Seeded JAX variables, and the port module holding them (eval mode)."""
    v = seeded_variables(jax_module, *args, seed=seed, **kwargs)
    sd = from_jax_variables(v["params"], v.get("batch_stats", {}), module=True)
    port_module.load_state_dict(sd, strict=True)
    return v, port_module.eval()


def _nhwc(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _jax_apply(module, v, *args, **kwargs):
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(v, *args)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


# ------------------------------------------------------------------ backbones

def _jax_backbone(case):
    name, kw = case
    if name in pb.BACKBONES:
        return jb.build_backbone(name, **kw)
    if name == "mobilenet16":
        return jb.MobileNetV2Dilated(16)
    return jb.MITResNet(*kw["args"])


def _port_backbone(case):
    name, kw = case
    if name in pb.BACKBONES:
        return pb.build_backbone(name, **kw)
    if name == "mobilenet16":
        return pb.MobileNetV2Dilated(16)
    return pb.MITResNet(*kw["args"])


# (name, kwargs): registry names at full depth where they are small, the deep
# ResNets and ResNeXt at a cut depth through MITResNet(block, layers, groups,
# dilate_scale) with the dilations of their registry names
BACKBONE_CASES = {
    "resnet18": ("resnet18", {}),
    "resnet18dilated": ("resnet18dilated", {}),
    "resnet50_cut": ("cut", {"args": ("bottleneck", (1, 1, 1, 1), 1, 0)}),
    "resnet101dilated_cut": ("cut", {"args": ("bottleneck", (1, 2, 2, 2), 1, 8)}),
    "resnext101_cut16": ("cut", {"args": ("group", (1, 1, 2, 1), 32, 16)}),
    "mobilenetv2dilated": ("mobilenetv2dilated", {}),
    "mobilenetv2dilated16": ("mobilenet16", {}),
}


@pytest.mark.parametrize("case", sorted(BACKBONE_CASES))
def test_backbone_matches_jax(case):
    """Every level of the pyramid within 2e-5 of the JAX module's (about
    ten conv layers deep at most here)."""
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm, port = _jax_backbone(BACKBONE_CASES[case]), _port_backbone(BACKBONE_CASES[case])
    v, port = _carry(jm, port, jnp.asarray(x))
    ref = _jax_apply(jm, v, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nhwc(x))
    assert len(got) == len(ref)
    for level, (g, r) in enumerate(zip(got, ref)):
        assert _to_nhwc(g).shape == r.shape, level
        assert rel_err(_to_nhwc(g), r) <= 2e-5, (case, level)
    with torch.no_grad():
        (last,) = port(_nhwc(x), return_feature_maps=False)
    assert torch.equal(last, got[-1])


@pytest.mark.parametrize("name", pb.BACKBONES)
def test_backbone_registry_keys_at_full_depth(name):
    """Each registry name's full-depth module has the JAX module's variables,
    one for one, at the transposed shapes (traced, not compiled)."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    key_coverage(pb.build_backbone(name), variable_shapes(jb.build_backbone(name), x))


def test_backbone_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown backbone"):
        pb.build_backbone("resnet34")


# ------------------------------------------------------------------ decoders

FC = 64  # the decoders' input width in these tests
PYRAMID = ((8, 16), (16, 8), (32, 8), (FC, 8))  # (channels, side) of conv_out


def _pyramid(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, s, s, c)).astype(np.float32) for c, s in PYRAMID]


def _decoders(arch, use_softmax):
    if arch == "upernet":
        kw = dict(num_class=7, fc_dim=FC, use_softmax=use_softmax)
        return (jd.UPerNet(fpn_inplanes=tuple(c for c, _ in PYRAMID), fpn_dim=16, **kw),
                pd.UPerNet(fpn_inplanes=tuple(c for c, _ in PYRAMID), fpn_dim=16, **kw))
    return (jd.build_legacy_decoder(arch, 7, FC, use_softmax),
            pd.build_legacy_decoder(arch, 7, FC, use_softmax))


@pytest.mark.parametrize("use_softmax", [False, True], ids=["log_softmax", "softmax"])
@pytest.mark.parametrize("arch", ["c1_deepsup", "ppm", "ppm_deepsup", "upernet"])
def test_legacy_decoder_matches_jax(arch, use_softmax):
    """Log-probabilities (each of a deep-supervision pair) within 1e-5, and
    with ``use_softmax`` the probabilities resized to ``seg_hw`` within 1e-5.
    The variables come from the training-branch module, which builds the
    deep-supervision head too."""
    feats = _pyramid(5)
    jm_train, _ = _decoders(arch, False)
    jm, port = _decoders(arch, use_softmax)
    jfeats = [jnp.asarray(f) for f in feats]
    v, port = _carry(jm_train, port, jfeats)
    seg_hw = (20, 24) if use_softmax else None
    ref = _jax_apply(jm, v, jfeats, seg_hw=seg_hw)
    with torch.no_grad():
        got = port([_nhwc(f) for f in feats], seg_hw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref) == (2 if arch.endswith("deepsup") and
                                    not use_softmax else 1)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert _to_nhwc(g).shape == r.shape
        assert rel_err(_to_nhwc(g), r) <= 1e-5
    if use_softmax:
        assert got[0].shape[-2:] == seg_hw
        torch.testing.assert_close(got[0].sum(1), torch.ones(2, *seg_hw), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["c1_deepsup", "ppm", "ppm_deepsup", "upernet"])
def test_legacy_decoder_registry_keys(arch):
    """The registry's modules at the published widths (fc_dim 2048, 150
    classes, UPerNet's ResNet-50 pyramid) hold the JAX modules' variables."""
    feats = [jnp.zeros((1, 8, 8, c), jnp.float32) for c in (256, 512, 1024, 2048)]
    key_coverage(pd.build_legacy_decoder(arch), variable_shapes(jd.build_legacy_decoder(arch),
                                                                 feats))
    with pytest.raises(ValueError, match="Unknown legacy decoder"):
        pd.build_legacy_decoder("c1")


def test_deep_sup_loss_on_a_pair():
    """``deep_sup_loss`` of C1DeepSup's (pred, pred_deepsup) pair with an NLL
    criterion, against the JAX package's on its own pair: within 1e-5."""
    feats = _pyramid(9)
    jm, port = _decoders("c1_deepsup", False)
    jfeats = [jnp.asarray(f) for f in feats]
    v, port = _carry(jm, port, jfeats)
    label = np.random.default_rng(2).integers(0, 7, (2, 8, 8))
    ref_pair = _jax_apply(jm, v, jfeats)
    ref = jax_deep_sup_loss(
        lambda p, y: -jnp.mean(jnp.take_along_axis(jnp.asarray(p), y[..., None], -1)),
        ref_pair, jnp.asarray(label), 0.4)
    with torch.no_grad():
        pair = port([_nhwc(f) for f in feats])
    got = deep_sup_loss(lambda p, y: torch.nn.functional.nll_loss(p, y), pair,
                        torch.from_numpy(label), 0.4)
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))


def test_segmentation_module_takes_a_legacy_decoder():
    """``SegmentationModule(decoder_module=...)`` runs a legacy decoder on
    its encoder's output: NHWC log-probabilities, and ``infer``'s softmax at
    ``seg_hw``."""
    from fovealseg_torch.models.deform_module import DeformConfig
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.models.segmentation_module import SegmentationModule

    cfg = DeformConfig(arch_encoder="hrnetv2_nodownsp_tiny", num_class=7)
    model = SegmentationModule(cfg, device="cpu",
                               decoder_module=pd.PPM(7, 960, pool_scales=(1, 2)))
    init_weights(model, torch.Generator().manual_seed(1))
    x = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        logp = model(x)
    assert logp.shape == (1, 16, 16, 7)
    torch.testing.assert_close(logp.exp().sum(-1), torch.ones(1, 16, 16), rtol=0, atol=1e-5)
    probs = model.infer(x, seg_hw=(24, 20))
    assert probs.shape == (1, 24, 20, 7) and probs.dtype == torch.float32


# ------------------------------------------------------------------ SegHRNet

def _tiny_extra(final_k=1, stage2_block="BASIC"):
    """The two tiny extras of ``tests/test_seg_hrnet.py``."""
    return dict(
        STAGE2=dict(NUM_MODULES=1, NUM_BRANCHES=2, NUM_BLOCKS=[1, 1],
                    NUM_CHANNELS=[4, 8], BLOCK=stage2_block, FUSE_METHOD="SUM"),
        STAGE3=dict(NUM_MODULES=2, NUM_BRANCHES=3, NUM_BLOCKS=[1, 1, 1],
                    NUM_CHANNELS=[4, 8, 16], BLOCK="BASIC", FUSE_METHOD="SUM"),
        STAGE4=dict(NUM_MODULES=1, NUM_BRANCHES=4, NUM_BLOCKS=[1, 1, 1, 1],
                    NUM_CHANNELS=[4, 8, 16, 32], BLOCK="BASIC", FUSE_METHOD="SUM"),
        FINAL_CONV_KERNEL=final_k,
    )


@pytest.mark.parametrize("final_k,stage2_block", [(1, "BASIC"), (3, "BOTTLENECK")])
def test_seg_hrnet_matches_jax(final_k, stage2_block):
    """Class logits at 1/4 resolution within 2e-5 of the JAX module's."""
    extra = _tiny_extra(final_k, stage2_block)
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jm = js.SegHRNet(num_classes=7, extra=extra)
    v, port = _carry(jm, ps.SegHRNet(7, extra), jnp.asarray(x), seed=11 + final_k)
    ref = _jax_apply(jm, v, jnp.asarray(x))
    with torch.no_grad():
        got = _to_nhwc(port(_nhwc(x)))
    assert got.shape == ref.shape == (2, 16, 16, 7)
    assert rel_err(got, ref) <= 2e-5


def test_seg_hrnet_w48_keys():
    """``get_seg_model`` with the published W48 extra holds the JAX
    module's variables one for one (traced, not compiled)."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    assert ps.W48_EXTRA == {k: v for k, v in js.W48_EXTRA.items()}
    key_coverage(ps.get_seg_model(19), variable_shapes(js.get_seg_model(19), x))
