"""Port: the score-map slice of ``infer`` against the JAX package, tiny size.

``hrnetv2_nodownsp_tiny``, 64x64 canvas, 16x16 task and saliency, radius 5,
51 classes, f32 on the CPU, the same PRNGKey(0) weights on both sides (as
``test_torch_port_slice.py``). Each ``rev_deform_interp`` ('nearest', 'BI',
'tri') runs ``infer(argmax_labels=False)`` with ``y``,
``y_sampled_reverse=True`` and ``x_sampled_reverse=True`` once on each side.

Tolerances. The logits differ by ~1e-6 relative (test_torch_port_slice.py),
so the logits-derived maps (``pred_sampled``, ``x_sampled_reverse``) are held
to the slice test's 1e-4 relative. The JAX package on the CPU runs its jump floods as
the lax chain, which tie-breaks equidistant seeds differently from the Pallas
kernel the port follows (test_torch_port_unwarp.py); a tie picks another
task pixel, and so another value. The comparison therefore covers the pixels
whose jump-flood winner agrees with the lax chain's (and, for 'BI'/'tri',
every pixel the splat reaches): >= 95% of them here, the bound of the JAX
package's own Pallas-vs-lax test. Labels (``y_sampled``, ``y_sampled_reverse``
in 'nearest' and 'tri') are compared exactly on those pixels, 'BI' labels
(fractional at holes) to 1e-5. Fed the JAX ``pred`` and ``grid``, the port's
score map and label round trip are bit-equal to the Pallas composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovealseg_tpu.core import unwarp as junwarp
from fovealseg_tpu.core.grid import inverse_grid_index as jax_inverse_grid_index
from fovealseg_tpu.models.deform_module import DeformConfig as JaxConfig
from fovealseg_tpu.models.deform_module import DeformSegmentation as JaxDeform
from fovealseg_tpu.ops.pallas_jfa import nearest_payload_packed_pallas, nearest_seed_pallas
from fovealseg_torch.core import unwarp
from fovealseg_torch.core.grid import inverse_grid_index
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.train.checkpoint import from_jax_variables

TINY = dict(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16), gaussian_radius=5,
            num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
INTERPS = ["nearest", "BI", "tri"]
SEG_HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    """{interp: (jax outputs, port outputs)} plus the inputs and weights."""
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    y = rng.integers(0, 51, (2, 64, 64)).astype(np.int32)
    y[0, :8] = 60  # labels outside [0, num_class): an all-zero one-hot plane
    v = jax.jit(JaxDeform(config=JaxConfig(**TINY)).init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                           jnp.asarray(f))
    state = from_jax_variables(jax.tree.map(np.asarray, v["params"]),
                               jax.tree.map(np.asarray, v["batch_stats"]))
    out = {}
    for interp in INTERPS:
        cfg = dict(TINY, rev_deform_interp=interp)
        jax_out = JaxDeform(config=JaxConfig(**cfg)).apply(
            v, jnp.asarray(x), jnp.asarray(f), y=jnp.asarray(y), y_sampled_reverse=True,
            x_sampled_reverse=True, method=JaxDeform.infer)
        model = DeformSegmentation(DeformConfig(**cfg), device="cpu")
        model.load_state_dict(state, strict=True)
        got = model.infer(torch.from_numpy(x), torch.from_numpy(f), y=torch.from_numpy(y),
                          y_sampled_reverse=True, x_sampled_reverse=True)
        out[interp] = (jax.tree.map(np.asarray, jax_out), {k: t.numpy() for k, t in got.items()})
    return dict(out=out, x=x, f=f, y=y, state=state)


def _agree(jax_out, kind):
    """Pixels whose jump-flood winner is the same in the port (Pallas
    semantics) and in the JAX package's CPU lax chain, given the JAX grid:
    'payload' for the score-map flood (K2), 'seed' for the fill flood (K4),
    'splat' for the seed flood or any pixel the 5x5 splat reaches."""
    task_idx, valid = jax_inverse_grid_index(jnp.asarray(jax_out["grid"]), SEG_HW)
    if kind == "payload":
        rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(jax_out["grid"]), SEG_HW)
        ours = nearest_payload_packed_pallas(valid, task_idx, 8, interpret=True, rounds=rounds)
        return np.asarray(ours) == np.asarray(junwarp.nearest_seed_payload(valid, task_idx))
    ours = np.asarray(nearest_seed_pallas(valid, interpret=True))
    same = ours == np.asarray(junwarp.nearest_seed_jfa(valid))
    if kind == "seed":
        return same
    vf = torch.from_numpy(np.asarray(valid, np.float32)[..., None])
    acc = sum(unwarp._shift2d(vf, dy, dx) for dy in range(-2, 3) for dx in range(-2, 3))
    return same | (acc.numpy()[..., 0] > 0)


@pytest.fixture(scope="module")
def agree(runs):
    """{(interp, kind): mask}; the kind a branch's fill uses."""
    return {(interp, kind): _agree(runs["out"][interp][0], kind)
            for interp in INTERPS for kind in (("payload", "seed") if interp == "nearest"
                                               else ("splat",))}


def _kind(interp, key):
    if interp != "nearest":
        return "splat"
    return "seed" if key == "x_sampled_reverse" else "payload"


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


@pytest.mark.parametrize("interp", INTERPS)
def test_keys_shapes_and_dtypes(runs, interp):
    jax_out, out = runs["out"][interp]
    assert set(out) == set(jax_out)
    for k in out:
        assert out[k].shape == jax_out[k].shape, k
        assert out[k].dtype == jax_out[k].dtype, k
    assert out["pred_sampled"].shape == (2, 64, 64, 51)
    assert np.isfinite(out["pred_sampled"]).all() and np.isfinite(out["x_sampled_reverse"]).all()


@pytest.mark.parametrize("interp", INTERPS)
def test_agreement_share(agree, interp):
    for kind in ("payload", "seed", "splat"):
        if (interp, kind) in agree:
            assert agree[interp, kind].mean() >= 0.95, kind


@pytest.mark.parametrize("interp", INTERPS)
def test_pred_sampled(runs, agree, interp):
    jax_out, out = runs["out"][interp]
    ok = agree[interp, _kind(interp, "pred_sampled")]
    assert _rel(out["pred_sampled"][ok], jax_out["pred_sampled"][ok]) <= 1e-4


@pytest.mark.parametrize("interp", INTERPS)
def test_y_sampled(runs, interp):
    jax_out, out = runs["out"][interp]
    np.testing.assert_array_equal(out["y_sampled"], jax_out["y_sampled"])


@pytest.mark.parametrize("interp", INTERPS)
def test_y_sampled_reverse(runs, agree, interp):
    jax_out, out = runs["out"][interp]
    ok = agree[interp, _kind(interp, "y_sampled_reverse")]
    got, ref = out["y_sampled_reverse"][ok], jax_out["y_sampled_reverse"][ok]
    if interp == "BI":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("interp", INTERPS)
def test_x_sampled_reverse(runs, agree, interp):
    """The image round trip fills by nearest seed (K4) in every mode."""
    jax_out, out = runs["out"][interp]
    ok = agree[interp, _kind(interp, "x_sampled_reverse")]
    assert _rel(out["x_sampled_reverse"][ok], jax_out["x_sampled_reverse"][ok]) <= 1e-4


def test_scoremap_bit_equal_given_jax_pred_and_grid(runs):
    """The port's score map and label round trip from the JAX ``pred`` and
    ``grid`` are bit-equal to the Pallas composition (K2 in interpret mode at
    the grid-derived rounds, then the flat gathers)."""
    jax_out, _ = runs["out"]["nearest"]
    pred, g = np.array(jax_out["pred"]), np.array(jax_out["grid"])
    task_idx, valid = jax_inverse_grid_index(jnp.asarray(g), SEG_HW)
    rounds = junwarp.jfa_rounds_from_grid(jnp.asarray(g), SEG_HW)
    tidx = nearest_payload_packed_pallas(valid, task_idx, 8, interpret=True, rounds=rounds)
    p2 = junwarp.halfpixel_avg(jnp.asarray(pred)).reshape(2, 256, 51)
    ref = np.asarray(junwarp._gather_rows_flat(p2, tidx.reshape(2, -1))).reshape(2, 64, 64, 51)
    args = (torch.from_numpy(np.array(task_idx)), torch.from_numpy(np.array(valid)), None,
            unwarp.jfa_rounds_from_grid(torch.from_numpy(g), SEG_HW))
    got = unwarp.unwarp_prediction_fast(torch.from_numpy(pred), *args)
    np.testing.assert_array_equal(got.numpy(), ref)
    y_s = np.array(jax_out["y_sampled"][..., None])
    ref_y = np.take_along_axis(y_s.reshape(2, 256), np.asarray(tidx).reshape(2, -1), axis=1)
    got_y = unwarp.unwarp_labels_fast(torch.from_numpy(y_s), *args)
    np.testing.assert_array_equal(got_y.numpy().reshape(2, -1), ref_y)


def test_argmax_labels_in_bi_are_the_score_maps_argmax(runs):
    """With 'BI'/'tri', ``pred_label`` is the argmax of ``pred_sampled``."""
    model = DeformSegmentation(DeformConfig(**TINY, rev_deform_interp="BI"), device="cpu")
    model.load_state_dict(runs["state"], strict=True)
    out = model.infer(torch.from_numpy(runs["x"]), torch.from_numpy(runs["f"]), argmax_labels=True)
    assert out["pred_label"].dtype == torch.int32
    torch.testing.assert_close(out["pred_label"],
                               torch.argmax(out["pred_sampled"], dim=-1).to(torch.int32),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(out["pred_sampled"].numpy(),
                                  runs["out"]["BI"][1]["pred_sampled"])


@pytest.mark.parametrize("jfa_iters", [3, 9])
def test_jfa_iters_on_the_score_map(runs, jfa_iters):
    """TPU.jfa_iters fixes the round count on both sides of REL_MAX_ROUNDS
    (9 takes K3 through K2's fallback): the score map equals the
    composition at that count."""
    model = DeformSegmentation(DeformConfig(**TINY, jfa_iters=jfa_iters), device="cpu")
    model.load_state_dict(runs["state"], strict=True)
    out = model.infer(torch.from_numpy(runs["x"]), torch.from_numpy(runs["f"]))
    task_idx, valid = inverse_grid_index(out["grid"], SEG_HW)
    tidx = nearest_payload_packed_pallas(jnp.asarray(valid.numpy()), jnp.asarray(task_idx.numpy()),
                                         8, jfa_iters, interpret=True)
    p2 = unwarp.halfpixel_avg(out["pred"]).reshape(2, 256, 51).numpy()
    ref = np.take_along_axis(p2, np.asarray(tidx).reshape(2, -1, 1), axis=1)
    np.testing.assert_array_equal(out["pred_sampled"].numpy().reshape(2, -1, 51), ref)
