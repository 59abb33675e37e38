"""Port: a reference saliency file with keys the model has no module for
loads as the JAX package's import loads it.

A ResNetZoom ``resnet18`` saliency file of the reference carries the
torchvision net's ``layer4.*`` and ``fc.*``, which the saliency net does not
use. The JAX package's ``load_torch_weight_files`` skips and logs them
(``strict=False``, as the reference loads); the port's does the same. Both
packages load the same file here, and the port's saliency weights must equal
the JAX package's import, carried over with ``from_jax_variables``, bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.configs import get_default_cfg as jax_default_cfg
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.train.checkpoint import load_torch_weight_files as jax_load
from fovealseg_torch.configs import get_default_cfg
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.models.layers import init_weights
from fovealseg_torch.train.checkpoint import from_jax_variables, load_torch_weight_files

OPTS = ["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(32,32)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
        "MODEL.saliency_net", "resnet18"]
EXTRA = {"layer4.0.conv1.weight": (512, 256, 3, 3), "fc.weight": (1000, 512), "fc.bias": (1000,)}


def _cfg(make):
    c = make()
    c.merge_from_file("fovealseg_torch/configs/deform.yaml")
    c.merge_from_list(OPTS)
    return c


def test_reference_saliency_file_with_unused_keys_loads_as_the_jax_import(tmp_path, caplog):
    src = init_weights(DeformSegmentation(DeformConfig.from_cfg(_cfg(get_default_cfg)),
                                          device="cpu"), torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in src.localization.state_dict().items()}
    gen = torch.Generator().manual_seed(6)
    assert not set(EXTRA) & set(sd)
    sd.update({k: torch.randn(shape, generator=gen) for k, shape in EXTRA.items()})
    path = str(tmp_path / "saliency_resnet18.pth")
    torch.save(sd, path)

    port = DeformSegmentation(DeformConfig.from_cfg(_cfg(get_default_cfg)), device="cpu")
    with caplog.at_level("WARNING", logger="fovealseg"):
        assert load_torch_weight_files(port, {"saliency": path}) == ["saliency"]
    for k in EXTRA:
        assert k in caplog.text

    jm = JaxDeform(config=JaxConfig.from_cfg(_cfg(jax_default_cfg)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.full((1, 2), 0.5))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = jax_load({"saliency": path}, zeros["params"], zeros["batch_stats"])
    ref = from_jax_variables(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    got = port.localization.state_dict()
    assert {f"localization.{k}" for k in got} == {k for k in ref
                                                  if k.startswith("localization.")}
    for k, t in got.items():
        torch.testing.assert_close(t, ref[f"localization.{k}"], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0, msg=k)
    with pytest.raises(RuntimeError):
        load_torch_weight_files(port, {"saliency": path}, strict=True)
