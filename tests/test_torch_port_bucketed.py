"""Port: dynamic task sizing (``models/bucketed.py``) against the JAX package.

``derive_task_size`` against the JAX rule over a grid of sizes; the port's
``BucketedDeform`` keeps one set of weights and derives each size's task and
saliency geometry from the raw size (the JAX package pads to a bucket of 32
first, so at a size that is a multiple of 32, or with ``bucket_multiple=1``,
both derive the same geometry). Labels of the tiny flagship (f32 on the CPU,
the JAX module's seeded variables) agree with the JAX ``BucketedDeform``'s
on >= 99.5% of pixels, for the reason ``test_torch_port_slice.py`` gives.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.models import bucketed as jbucket
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_torch.models.bucketed import BucketedDeform, derive_task_size
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import from_jax_variables
from tests.torch_port_zoo import cut_encoders, seeded_variables

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
DYNAMIC = (16, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_derive_task_size_matches_jax():
    sizes = [(h, w) for h in (17, 32, 64, 96, 100, 333, 512, 683, 1024)
             for w in (17, 48, 64, 96, 129, 683, 1365)]
    for dyn in ((16, 16), (80, 80), (64, 128), (1, 1)):
        for hw in sizes:
            assert derive_task_size(hw, dyn) == jbucket.derive_task_size(hw, dyn), (hw, dyn)


@pytest.fixture(scope="module")
def models():
    """The JAX module's seeded variables (traced, not compiled), and the port
    model holding them."""
    x = jnp.zeros((2, 64, 64, 3), jnp.float32)
    f = jnp.full((2, 2), 0.5, jnp.float32)
    v = seeded_variables(JaxDeform(config=JaxConfig(**TINY)), x, f, seed=4)
    model = DeformSegmentation(DeformConfig(**TINY), device="cpu")
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    return v, model


@pytest.mark.parametrize("relative", [1.0, 0.5])
def test_one_set_of_weights_and_per_size_geometry(models, relative):
    _, model = models
    bucketed = BucketedDeform(model, DYNAMIC, relative)
    jax_b = jbucket.BucketedDeform(JaxConfig(**TINY), DYNAMIC, relative, bucket_multiple=1)
    views = {hw: bucketed.module_for(hw) for hw in ((64, 96), (60, 84), (96, 64))}
    for hw, view in views.items():
        want = jax_b.module_for(hw).config
        assert (view.config.task_hw, view.config.task_hw_infer, view.config.saliency_hw) == (
            tuple(want.task_hw), tuple(want.task_hw_infer), tuple(want.saliency_hw)), hw
        assert dataclasses.replace(view.config, task_hw=TINY["task_hw"],
                                   task_hw_infer=TINY["task_hw_infer"],
                                   saliency_hw=TINY["saliency_hw"]) == model.config
        for a, b in zip(view.parameters(), model.parameters()):
            assert a is b  # the same weights, not a copy
    assert bucketed.module_for((64, 96)) is views[(64, 96)]  # built once per size
    assert model.config == DeformConfig(**TINY)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX sub-networks under ``flax.linen.jit`` (``cut_encoders``, which
    cuts nothing at these archs), so that the eager ``infer`` compiles each
    net as one program."""
    with cut_encoders():
        yield


@pytest.mark.parametrize("hw,multiple", [((64, 96), 32), ((60, 84), 1)],
                         ids=["bucket_size", "raw_size"])
def test_labels_agree_with_jax_bucketed(models, jax_reference, hw, multiple):
    """At a size that is a multiple of 32 (the JAX package's default bucket,
    so no pad), and at one that is not with ``bucket_multiple=1``: the same
    geometry, and labels on >= 99.5% of pixels; the port's bucketed labels
    bit-equal to a plain ``DeformSegmentation`` built at that geometry."""
    v, model = models
    rng = np.random.default_rng(sum(hw))
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    f = rng.uniform(0.3, 0.7, (2, 2)).astype(np.float32)
    jax_b = jbucket.BucketedDeform(JaxConfig(**TINY), DYNAMIC, bucket_multiple=multiple)
    ref = np.asarray(jax_b.apply(v, jnp.asarray(x), jnp.asarray(f), argmax_labels=True,
                                 method=JaxDeform.infer)["pred_label"])
    bucketed = BucketedDeform(model, DYNAMIC)
    got = bucketed.infer(torch.from_numpy(x), torch.from_numpy(f), argmax_labels=True)
    assert got["pred_label"].shape == ref.shape == (2, *hw)
    assert (got["pred_label"].numpy() == ref).mean() >= 0.995
    plain = DeformSegmentation(bucketed.module_for(hw).config, device="cpu")
    plain.load_state_dict(model.state_dict())
    again = plain.infer(torch.from_numpy(x), torch.from_numpy(f), argmax_labels=True)
    assert torch.equal(again["pred_label"], got["pred_label"])
    assert torch.equal(again["grid"], got["grid"])
