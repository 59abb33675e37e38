"""Port: the exact 'tri' hole fill against the JAX package on the CPU.

The port builds its own copy of ``spatial.cpp`` with the host's ``g++``
(``fovealseg_torch/native/spatial.py``); the JAX package builds the same
three entry points with its ``Makefile``. So the host plans are compared bit
for bit, and the fills, which add a bilinear sample and a 3-term blend in
f32, to 1e-5.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.native import interp2d as jinterp
from fovealseg_tpu.native import spatial as jspatial
from fovealseg_torch.core.grid import grid_from_index, inverse_grid_index
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.models.layers import init_weights
from fovealseg_torch.native import interp2d, spatial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slice_case():
    """The inverse warp of the tiny model on a 64x64 canvas (16x16 task):
    pred [2, 16, 16, 51], grid_inv [2, 64, 64, 2] with NaN holes, valid."""
    rng = np.random.default_rng(31)
    model = init_weights(DeformSegmentation(DeformConfig(**TINY), device="cpu"),
                         torch.Generator().manual_seed(31))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32))
    out = model.infer(x, f)
    task_idx, valid = inverse_grid_index(out["grid"], (64, 64))
    grid_inv = grid_from_index(task_idx, valid, (16, 16))
    return out["pred"].float(), grid_inv, valid


def _masks(slice_case):
    rng = np.random.default_rng(32)
    block = np.ones((40, 52), bool)
    block[8:30, 10:44] = False
    block[0, 0] = block[-1, -1] = False  # two invalid corners: value 0 there
    return {"slice_64x64": slice_case[2][0].numpy(),
            "random_90pct_holes_48x40": rng.uniform(size=(48, 40)) > 0.9,
            "block_hole_40x52": block}


@pytest.mark.parametrize("name", ["slice_64x64", "random_90pct_holes_48x40", "block_hole_40x52"])
def test_build_fill_plan_bit_equal(slice_case, name):
    valid = _masks(slice_case)[name]
    corner, weight = interp2d.build_fill_plan(valid)
    jcorner, jweight = jinterp.build_fill_plan(valid)
    assert corner.dtype == np.int32 and weight.dtype == np.float32
    np.testing.assert_array_equal(corner, jcorner)
    np.testing.assert_array_equal(weight, jweight)
    flat = valid.ravel()
    np.testing.assert_array_equal(corner[flat, 0], np.flatnonzero(flat))  # identity at valid
    assert (~flat).sum() > 0


@pytest.mark.parametrize("name", ["random_90pct_holes_48x40", "block_hole_40x52"])
def test_fill_missing_tri_equal(slice_case, name):
    """The host oracle: the same numpy arithmetic on the same plan."""
    valid = _masks(slice_case)[name]
    values = np.random.default_rng(33).normal(size=(*valid.shape, 3)).astype(np.float32)
    got = interp2d.fill_missing_tri(values * valid[..., None], valid)
    ref = jinterp.fill_missing_tri(values * valid[..., None], valid)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[valid], values[valid])


def test_unwarp_prediction_tri_device_against_jax(slice_case):
    """Within 1e-5: the port samples with F.grid_sample, the JAX package
    with its own bilinear gather, and the plans are bit-equal."""
    pred, grid_inv, valid = slice_case
    got = interp2d.unwarp_prediction_tri_device(pred, grid_inv, valid)
    ref = np.asarray(jinterp.unwarp_prediction_tri_device(jnp.asarray(pred.numpy()),
                                                          jnp.asarray(grid_inv.numpy()),
                                                          jnp.asarray(valid.numpy())))
    assert got.shape == (2, 64, 64, 51) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_device_path_matches_host_oracle(slice_case):
    """The production path (plan + batched blend) against the per-sample
    host oracle, both in the port, within 1e-5; and the JAX package's host
    oracle within the same."""
    pred, grid_inv, valid = slice_case
    got = interp2d.unwarp_prediction_tri_device(pred, grid_inv, valid).numpy()
    host = interp2d.unwarp_prediction_tri(pred, grid_inv, valid)
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)
    jhost = jinterp.unwarp_prediction_tri(jnp.asarray(pred.numpy()),
                                          jnp.asarray(grid_inv.numpy()), valid.numpy())
    np.testing.assert_allclose(host, jhost, rtol=0, atol=1e-5)


def test_delaunay_and_nearest_neighbor_equal():
    pts = np.random.default_rng(34).uniform(0, 50, (300, 2))
    q = np.random.default_rng(35).uniform(-5, 55, (500, 2))
    tri, jtri = spatial.Delaunay(pts), jspatial.Delaunay(pts)
    np.testing.assert_array_equal(tri.simplices, jtri.simplices)
    s, c = tri.find_simplex(q, return_c=True)
    js, jc = jtri.find_simplex(q, return_c=True)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(c, jc)
    assert (s >= 0).any() and (s < 0).any()
    np.testing.assert_array_equal(spatial.nearest_neighbor(pts, q),
                                  jspatial.nearest_neighbor(pts, q))


def test_library_built_by_the_port(tmp_path, monkeypatch):
    """The port's library comes from fovealseg_torch/native/spatial.cpp by
    the port's own build function, into a hashed file; a failed build raises."""
    monkeypatch.setattr(spatial, "BUILD_DIR", tmp_path / "native")
    lib = spatial.build()
    assert lib.exists() and lib.parent == tmp_path / "native"
    assert lib.name.startswith("libspatial-") and lib.suffix == ".so"
    assert spatial.SOURCE == Path(REPO) / "fovealseg_torch" / "native" / "spatial.cpp"
    assert spatial.build() == lib  # built once, then reused
    monkeypatch.setattr(spatial, "BUILD_DIR", tmp_path / "failing")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        spatial.build()
    assert not os.path.exists(tmp_path / "failing" / lib.name)


def test_no_binary_shipped():
    """The port carries sources only: no shared library under its tree."""
    shipped = [p for p in Path(REPO, "fovealseg_torch").rglob("*") if p.suffix in (".so", ".o")]
    assert shipped == []
