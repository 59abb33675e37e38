"""Port: which convs run W8A8 (``TPU.quantize="int8"``), against the JAX
package, on the CPU.

The JAX package quantizes the convs it builds as ``TorchConv`` with at least
128 input and output channels, and names them with
``quantized_kernel_paths`` (an abstract forward with its publish flag on).
The port marks the counterparts of the JAX package's plain ``nn.Conv``s
``quantizable=False`` where it builds them. Here the convs that run the
int8 path in the port's ``infer`` (forward hooks on the convs
``quantize_model`` quantized; each runs once per call) equal the JAX
package's set, mapped to torch names, for the flagship (HRNetV2 + C1 +
FovSim), SegFormer-B5, DeepLabV3-R101 and each ResNetZoom net. The JAX side
is traced per sub-network on the shapes ``infer`` gives it, through
``jax.eval_shape`` (no compile): one abstract ``init`` with the publish flag
on, the mechanism of ``quantized_kernel_paths``, which the saliency and
compress nets also run as such and must agree with.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models import builder as jbuilder
from fovealseg_tpu.models import layers as jlayers
from fovealseg_torch.models import layers
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.ops import quant


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_paths(module, *args, check: bool = False) -> tuple[set, object]:
    """The scope paths of the quant entries that ``module``'s W8A8 forward
    reads on ``args``, and its output's shape: one abstract ``init`` with
    the JAX package's publish flag on, the mechanism of
    ``quantized_kernel_paths`` (which traces an ``init`` and an ``apply``);
    ``check`` also runs that function and requires the same set."""
    with jlayers.quantization(), jlayers._quant_publish():
        out, variables = jax.eval_shape(
            lambda *a: module.init_with_output(jax.random.PRNGKey(0), *a), *args)
    paths = {p[:-1] for p in flax.traverse_util.flatten_dict(variables.get("quant", {}))}
    if check:
        plain = {k: v for k, v in variables.items() if k != "quant"}
        assert paths == jlayers.quantized_kernel_paths(module, plain, *args)
    return paths, out


def _jax_int8_names(saliency: str, arch: str, fc_dim: int, subnets) -> set:
    """The torch names of the convs the JAX package's W8A8 ``infer`` reads,
    from each of ``subnets`` traced on the shapes ``infer`` gives it."""
    names, x5, x3 = set(), jnp.zeros((2, 16, 16, 5)), jnp.zeros((2, 16, 16, 3))
    if {"localization", "net_compress"} & set(subnets):
        paths, sal = _jax_paths(jbuilder.build_net_saliency(saliency), x5, check=True)
        names |= {"localization." + ".".join(p) for p in paths}
        paths, _ = _jax_paths(jbuilder.build_net_compress(saliency), jnp.zeros(sal.shape),
                              check=True)
        names |= {"net_compress." + ".".join(p) for p in paths}
    if {"encoder", "decoder"} & set(subnets):
        paths, feats = _jax_paths(jbuilder.build_encoder(arch, fc_dim), x3)
        names |= {"encoder." + ".".join(p) for p in paths}
        feats = jax.tree.map(lambda s: jnp.zeros(s.shape), feats)
        paths, _ = _jax_paths(jbuilder.build_decoder("c1", fc_dim, 51), feats)
        names |= {"decoder." + ".".join(p) for p in paths}
    return names


# family -> (saliency net, encoder, fc_dim, the sub-networks compared); the
# ResNetZoom cases build the port with the tiny HRNet and compare the
# saliency and compress nets, the flagship case the whole encoder and decoder
FAMILIES = {
    "flagship": ("fovsimple", "hrnetv2_nodownsp", 960,
                 ("localization", "net_compress", "encoder", "decoder")),
    "segformer_b5": ("fovsimple", "segformer", 1024, ("encoder", "decoder")),
    "deeplabv3_r101": ("fovsimple", "deeplab", 960, ("encoder", "decoder")),
    **{name: (name, "hrnetv2_nodownsp_tiny", 960, ("localization", "net_compress"))
       for name in ("resnet18", "resnet18_nonsyn", "resnet18_stride1", "resnet10_nonsyn")},
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_convs_are_the_jax_quantized_kernel_paths(family):
    saliency, arch, fc_dim, subnets = FAMILIES[family]
    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder=arch, fc_dim=fc_dim,
                       saliency_net=saliency)
    model = DeformSegmentation(cfg, device="cpu")
    stored = layers.quantize_model(model)
    ran = []
    for name, m in model.named_modules():
        if "weight_q" in m._buffers:
            m.register_forward_hook(lambda mod, i, o, name=name: ran.append(name))
    calls = quant.int8_conv2d.plain_calls
    rng = np.random.default_rng(5)
    model.infer(torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)),
                torch.full((2, 2), 0.5), argmax_labels=True)
    assert len(ran) == len(set(ran)) == stored == quant.int8_conv2d.plain_calls - calls
    ran = {n for n in ran if n.split(".")[0] in subnets}
    assert ran == _jax_int8_names(saliency, arch, fc_dim, subnets)
    assert ran  # every family runs some convs int8
