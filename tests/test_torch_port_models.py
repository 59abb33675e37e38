"""Port: weights carried from the JAX package and the sub-networks' eval
forwards.

The JAX model is initialised once with ``jax.random.PRNGKey(0)``; its
exported state dict (``export_torch_state_dict``) is the oracle for
``from_jax_variables``. Forwards run in f32 on the CPU and agree to 1e-4
relative to the output's largest magnitude: XLA and oneDNN order each conv's
sums differently, and the deep encoder compounds that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models.c1 import C1 as JaxC1
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.models.hrnet import HRNetV2NoDownsp as JaxHRNet
from fovealseg_tpu.models.saliency import CompressNet as JaxCompress
from fovealseg_tpu.models.saliency import FovSimModule as JaxFovSim
from fovealseg_tpu.train.checkpoint import export_torch_state_dict, save_torch_checkpoint
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import (
    SUBMODULE_OF_FILE,
    from_jax_variables,
    load_torch_checkpoint,
)

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
SUBTREES = ("localization", "net_compress", "encoder", "decoder")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_vars():
    module = JaxDeform(config=JaxConfig(**TINY))
    v = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 2)))
    return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"])


@pytest.fixture(scope="module")
def port(jax_vars):
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    model.load_state_dict(from_jax_variables(*jax_vars), strict=True)
    return model


def _exported(jax_vars):
    exp = export_torch_state_dict(*jax_vars)
    return {f"{SUBMODULE_OF_FILE[kind]}.{k}": v for kind, sd in exp.items() for k, v in sd.items()}


def test_from_jax_variables_matches_export(jax_vars):
    exp = _exported(jax_vars)
    ours = from_jax_variables(*jax_vars)
    assert set(ours) == set(exp)
    for k, v in exp.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("sub", SUBTREES)
def test_export_loads_strict_into_port(jax_vars, sub):
    exp = _exported(jax_vars)
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    keys = {k for k in model.state_dict() if k.startswith(sub + ".")}
    assert keys == {k for k in exp if k.startswith(sub + ".")}
    part = {k[len(sub) + 1:]: torch.from_numpy(np.array(v)) for k, v in exp.items()
            if k.startswith(sub + ".")}
    getattr(model, sub).load_state_dict(part, strict=True)


def test_flagship_keys_and_shapes_match_jax_tree():
    """Full-width flagship (HRNetV2-nodownsp (1,4,3) modules, 4 blocks, 960
    channels): every port key maps onto the JAX parameter tree through the
    JAX package's import convention, with transposed shapes, and the
    reverse. Shape-only on both sides (meta tensors, ``eval_shape``)."""
    jm = JaxDeform(config=JaxConfig())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 640, 640, 3)),
                            jnp.zeros((1, 2)))
    flat = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[col])[0]:
            flat[tuple(p.key for p in path)] = tuple(leaf.shape)
    with torch.device("meta"):
        model = DeformSegmentation(DeformConfig(), device="meta")
    leaf_of = {"running_mean": "mean", "running_var": "var"}
    seen = set()
    for key, t in model.state_dict().items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        top, path = mod[0], ".".join(mod[1:])
        if leaf == "weight":
            leaf = "kernel" if t.dim() in (2, 4) else "scale"
        matches = [p for p in flat if p[0] == top and ".".join(p[1:-1]) == path
                   and p[-1] == leaf_of.get(leaf, leaf)]
        assert len(matches) == 1, key
        jshape = flat[matches[0]]
        if t.dim() == 4:  # HWIO -> OIHW
            want = (jshape[3], jshape[2], jshape[0], jshape[1])
        else:
            want = jshape[::-1]  # Dense kernels transpose; 1-D shapes are their own reverse
        assert tuple(t.shape) == want, key
        seen.add(matches[0])
    assert seen == set(flat)


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_apply(module, jax_vars, sub, x):
    p, s = jax_vars
    variables = {"params": p[sub]}
    if sub in s:
        variables["batch_stats"] = s[sub]
    return np.asarray(module.apply(variables, jnp.asarray(x), train=False))


@pytest.mark.parametrize("sub", SUBTREES)
def test_subnetwork_eval_forward(jax_vars, port, sub):
    rng = np.random.default_rng(5)
    jax_module, in_ch = {"localization": (JaxFovSim(), 5), "net_compress": (JaxCompress(), 24),
                         "encoder": (JaxHRNet(stage_modules=(1, 1, 1), num_blocks=1,
                                              layer1_blocks=1), 3),
                         "decoder": (JaxC1(num_class=51, fc_dim=960), 960)}[sub]
    x = rng.normal(size=(2, 16, 16, in_ch)).astype(np.float32)
    ref = _jax_apply(jax_module, jax_vars, sub, x)
    if sub == "encoder":
        ref = ref[0]
    with torch.no_grad():
        out = getattr(port, sub)(torch.from_numpy(x).permute(0, 3, 1, 2))
    if sub == "encoder":
        assert len(out) == 1
        out = out[0]
    got = out.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= 1e-4


def test_four_file_checkpoint_loads(jax_vars, tmp_path):
    save_torch_checkpoint(str(tmp_path), 3, *jax_vars, also_last=False)
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    load_torch_checkpoint(model, str(tmp_path), 3)
    want = from_jax_variables(*jax_vars)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_four_file_checkpoint_missing_file_raises(jax_vars, tmp_path):
    save_torch_checkpoint(str(tmp_path), 3, *jax_vars, also_last=False)
    (tmp_path / "decoder_epoch_3.pth").unlink()
    with pytest.raises(FileNotFoundError):
        load_torch_checkpoint(DeformSegmentation(DeformConfig(**TINY), device="cpu"),
                              str(tmp_path), 3)


def test_bf16_weight_cast_is_cached_and_refreshed(jax_vars):
    """bf16 compute keeps f32 parameters; the cast copy is reused across
    no-grad calls and refreshed when the parameter is overwritten."""
    model = DeformSegmentation(DeformConfig(**TINY), dtype=torch.bfloat16, device="cpu")
    conv = model.localization.fov_expand_1
    x = torch.zeros((1, 5, 8, 8))
    with torch.no_grad():
        conv(x)
        first = conv._cast["weight"][1]
        conv(x)
        assert conv._cast["weight"][1] is first
        model.load_state_dict(from_jax_variables(*jax_vars), strict=True)
        y = conv(x)
    assert conv.weight.dtype == torch.float32 and y.dtype == torch.bfloat16
    torch.testing.assert_close(conv._cast["weight"][1], conv.weight.to(torch.bfloat16),
                               rtol=0, atol=0)
