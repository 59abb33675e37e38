"""Port on the card: the CUDA kernels against their plain versions.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a machine with a card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fovealseg_torch.ops import jfa
from fovealseg_torch.ops.gather import (
    VARIANT_SCALAR,
    VARIANT_SMALL,
    VARIANT_WIDE,
    gather_variant,
    row_gather,
    row_gather_plain,
)
from fovealseg_torch.ops.jfa import full_rounds, nearest_class, nearest_class_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(shape, p_hole, seed):
    rng = np.random.default_rng(seed)
    valid = rng.uniform(0, 1, shape) > p_hole
    cls = rng.integers(0, 51, shape).astype(np.int32)
    return torch.from_numpy(valid), torch.from_numpy(cls)


@pytest.mark.parametrize("shape,p_hole", [((2, 64, 64), 0.95), ((3, 48, 80), 0.99),
                                          ((8, 640, 640), 0.995), ((8, 480, 640), 0.99),
                                          ((1, 33, 1000), 0.999)])
@pytest.mark.parametrize("rounds", ["2", "4", "full", "full+2", "device"])
def test_kernel_bit_equal_to_plain(dev, shape, p_hole, rounds):
    valid, cls = _case(shape, p_hole, seed=sum(shape))
    full = full_rounds(*shape[1:])
    if rounds == "device":  # a device scalar the kernel reads without a host sync
        r = torch.tensor(3, dtype=torch.int32, device=dev)
    else:
        r = {"full": full, "full+2": full + 2}.get(rounds) or int(rounds)
    before = nearest_class.launches
    out = nearest_class(valid.to(dev), cls.to(dev), 6, r)
    torch.cuda.synchronize()
    assert nearest_class.launches == before + 1
    ref = nearest_class_plain(valid, cls, 6, r.cpu() if torch.is_tensor(r) else r)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


def test_kernel_no_seed_and_single_seed(dev):
    valid = torch.zeros((2, 100, 130), dtype=torch.bool)
    valid[1, 99, 0] = True
    cls = torch.full((2, 100, 130), 9, dtype=torch.int32)
    out = nearest_class(valid.to(dev), cls.to(dev), 6).cpu()
    assert (out[0] == 0).all() and (out[1] == 9).all()


def test_kernel_rejects_non_contiguous(dev):
    valid, cls = _case((2, 64, 64), 0.9, 1)
    with pytest.raises(ValueError):
        nearest_class(valid.to(dev).transpose(1, 2), cls.to(dev).transpose(1, 2), 6)


def test_tiny_slice_on_card_matches_host(dev):
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
    torch.manual_seed(0)
    host = DeformSegmentation(cfg, device="cpu")
    card = DeformSegmentation(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.infer(x.to(dev), f.to(dev), argmax_labels=True)
    ref = host.infer(x, f, argmax_labels=True)
    torch.testing.assert_close(got["grid"].cpu(), ref["grid"], rtol=0, atol=1e-5)
    # the card's labels are exactly what the plain path makes of its own pred/grid
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter

    host_labels = unwarp_argmax_scatter(got["pred"].cpu(), got["grid"].cpu(), (64, 64),
                                        rounds=jfa_rounds_from_grid(got["grid"], (64, 64)).cpu())
    torch.testing.assert_close(got["pred_label"].cpu(), host_labels, rtol=0, atol=0)


def _rounds(rounds, full, dev):
    if rounds == "device":
        return torch.tensor(3, dtype=torch.int32, device=dev)
    return {"full": full, "full+2": full + 2}.get(rounds) or int(rounds)


def _host(r):
    return r.cpu() if torch.is_tensor(r) else r


@pytest.mark.parametrize("shape,p_hole", [((2, 64, 64), 0.95), ((3, 48, 80), 0.99),
                                          ((8, 640, 640), 0.995), ((1, 33, 1000), 0.999)])
@pytest.mark.parametrize("rounds", ["2", "7", "full", "device"])
def test_payload_and_seed_kernels_bit_equal_to_plain(dev, shape, p_hole, rounds):
    """K2, K3 and K4 against their plain versions."""
    valid, _ = _case(shape, p_hole, seed=sum(shape) + 1)
    h, w = shape[1:]
    pay = torch.randint(0, 2**13, shape, generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32)
    r = _rounds(rounds, full_rounds(h, w), dev)
    v, p = valid.to(dev), pay.to(dev)
    k2 = jfa.nearest_payload_packed(v, p, 13, r)
    k3 = jfa.nearest_payload(v, p * 3 + 2**20, r)  # wider than K2 takes
    k4 = jfa.nearest_seed(v, r)
    torch.cuda.synchronize()
    torch.testing.assert_close(k2.cpu(), jfa.nearest_payload_packed_plain(valid, pay, 13, _host(r)),
                               rtol=0, atol=0)
    wide = pay * 3 + 2**20
    torch.testing.assert_close(k3.cpu(), jfa.nearest_payload_plain(valid, wide, _host(r)),
                               rtol=0, atol=0)
    torch.testing.assert_close(k4.cpu(), jfa.nearest_seed_plain(valid, _host(r)), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 1, 1000), (9, 1000, 1), (2, 31, 33), (1, 65, 1000),
                                   (9, 65, 31), (3, 33, 65), (1, 7, 9), (9, 100, 31)])
@pytest.mark.parametrize("rounds", ["1", "full", "full+2", "device 1", "device full"])
def test_flood_tile_edges_bit_equal_to_plain(dev, shape, rounds):
    """K1-K4 on canvases that cut the flood's tiles and residue classes at
    every edge: sides of 1, 31, 33, 65 and 1000, a canvas narrower than one
    tile, b = 1 and b = 9, and device-scalar round counts of 1 and full."""
    b, h, w = shape
    valid, cls = _case(shape, 0.97 if h * w > 1000 else 0.8, seed=h * 7 + w)
    valid[0] = False  # an image with no seed
    full = full_rounds(h, w)
    r = {"1": 1, "full": full, "full+2": full + 2}.get(rounds)
    if rounds.startswith("device"):
        r = torch.tensor(1 if rounds.endswith("1") else full, dtype=torch.int32, device=dev)
    wide = cls * 40000 + 7
    v, c = valid.to(dev), cls.to(dev)
    outs = {"k1": nearest_class(v, c, 6, r), "k2": jfa.nearest_payload_packed(v, c, 13, r),
            "k3": jfa.nearest_payload(v, wide.to(dev), r), "k4": jfa.nearest_seed(v, r)}
    torch.cuda.synchronize()
    refs = {"k1": nearest_class_plain(valid, cls, 6, _host(r)),
            "k2": jfa.nearest_payload_packed_plain(valid, cls, 13, _host(r)),
            "k3": jfa.nearest_payload_plain(valid, wide, _host(r)),
            "k4": jfa.nearest_seed_plain(valid, _host(r))}
    for name, out in outs.items():
        torch.testing.assert_close(out.cpu(), refs[name], rtol=0, atol=0, msg=name)


def test_payload_packed_routes_host_rounds_past_seven_to_k3(dev):
    valid, pay = _case((2, 256, 256), 0.99, 7)
    before = (jfa.nearest_payload_packed.launches, jfa.nearest_payload.launches)
    jfa.nearest_payload_packed(valid.to(dev), pay.to(dev), 13, 8)
    jfa.nearest_payload_packed(valid.to(dev), pay.to(dev), 13, torch.tensor(8, dtype=torch.int32,
                                                                            device=dev))
    jfa.nearest_payload_packed(valid.to(dev), pay.to(dev), 13, 7)
    assert (jfa.nearest_payload_packed.launches, jfa.nearest_payload.launches) == (
        before[0] + 2, before[1] + 1)


def test_payload_and_seed_kernels_no_seed(dev):
    valid = torch.zeros((2, 100, 130), dtype=torch.bool)
    valid[1, 99, 0] = True
    pay = torch.full((2, 100, 130), 9, dtype=torch.int32)
    for out in (jfa.nearest_payload_packed(valid.to(dev), pay.to(dev), 13),
                jfa.nearest_payload(valid.to(dev), pay.to(dev))):
        out = out.cpu()
        assert (out[0] == 0).all() and (out[1] == 9).all()
    seed = jfa.nearest_seed(valid.to(dev)).cpu()
    assert (seed[0] == 0).all() and (seed[1] == 99 * 130).all()


def test_payload_and_seed_kernels_reject_bad_inputs(dev):
    valid, pay = _case((2, 64, 64), 0.9, 1)
    v, p = valid.to(dev), pay.to(dev)
    with pytest.raises(ValueError):
        jfa.nearest_payload_packed(v.transpose(1, 2), p.transpose(1, 2), 13)
    with pytest.raises(ValueError):
        jfa.nearest_payload(v.transpose(1, 2), p.transpose(1, 2))
    with pytest.raises(ValueError):
        jfa.nearest_seed(v.transpose(1, 2))
    with pytest.raises(ValueError):
        jfa.nearest_payload(v, p.to(torch.int64))
    with pytest.raises(ValueError):
        jfa.nearest_seed(v.to(torch.uint8))


def _at_offset(t: torch.Tensor, offset: int, dev) -> torch.Tensor:
    """``t`` on the card as a contiguous view at storage offset ``offset``."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    view = buf[offset:].view(t.shape)
    view.copy_(t.to(dev))
    return view


@pytest.mark.parametrize("b,t,c,hw,dtype,offset", [
    (8, 6400, 51, (640, 640), torch.float32, None),  # the score map: wide
    (8, 6400, 1, (640, 640), torch.int32, None),  # labels: small
    (8, 409600, 2, (640, 640), torch.float32, None),  # the filled grid: small
    (8, 409600, 3, (640, 640), torch.float32, None),  # an image: small
    (2, 4096, 2, (64, 64), torch.float32, None),
    (2, 33, 4, (8, 8), torch.int32, None),  # small, 16-byte rows
    (2, 300, 5, (8, 10), torch.float32, None),  # wide at its least C
    (3, 100, 300, (17, 23), torch.float32, None),  # wide, a chunk past a row's end
    (1, 7, 5, (1, 1), torch.int32, None),  # scalar: n * c % 4 != 0
    (3, 50, 4, (9, 7), torch.float32, None),  # scalar: pixels not a multiple of 4
    (2, 33, 3, (5, 7), torch.float32, None),
    (2, 300, 5, (9, 11), torch.float32, None),
    (2, 300, 51, (13, 17), torch.float32, None),
    (2, 1000, 1, (31, 33), torch.int32, None),
    (2, 4096, 2, (64, 64), torch.float32, "table"),  # storage offset 1: scalar
    (2, 4096, 4, (64, 64), torch.float32, "table"),
    (2, 100, 1, (64, 64), torch.int32, "idx"),
    (2, 4096, 3, (64, 64), torch.float32, "both"),
    (2, 6400, 51, (80, 80), torch.float32, "both"),  # wide: only the output must align
])
def test_row_gather_bit_equal_to_plain(dev, b, t, c, hw, dtype, offset):
    """K5 against its plain version in each of its variants: NaN and
    signed-zero words, indices out of range (clamped as the plain version
    clamps them), pixel counts that are not multiples of 4, and tables and
    index maps at storage offset 1."""
    g = torch.Generator().manual_seed(b * t + c)
    if dtype == torch.float32:
        table = torch.randn((b, t, c), generator=g)
        table.view(-1)[:: 97] = float("nan")
        table.view(-1)[1:: 101] = -0.0
    else:
        table = torch.randint(-2**31, 2**31 - 1, (b, t, c), generator=g, dtype=torch.int32)
    idx = torch.randint(-3, t + 3, (b, *hw), generator=g, dtype=torch.int32)
    table_d = _at_offset(table, 1 if offset in ("table", "both") else 0, dev)
    idx_d = _at_offset(idx, 1 if offset in ("idx", "both") else 0, dev)
    ref = row_gather_plain(table, idx)
    n = idx[0].numel()
    before = row_gather.launches
    out = row_gather(table_d, idx_d)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))
    chosen = gather_variant(c, n, table_d.data_ptr(), idx_d.data_ptr(), out.data_ptr())
    if c <= 4:
        small = n % 4 == 0 and offset is None
        assert chosen == (VARIANT_SMALL if small else VARIANT_SCALAR)
    else:
        assert chosen == (VARIANT_WIDE if n * c % 4 == 0 else VARIANT_SCALAR)


@pytest.mark.parametrize("c", [2, 51])
def test_row_gather_64bit_table_offsets(dev, c):
    """T * C >= 2^31 words (an 8.6 GB table): the kernel's per-image row
    offsets go 64-bit. Held against the plain version on the card."""
    t = 2**31 // c + 8
    table = torch.randint(-2**31, 2**31 - 1, (1, t, c), dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(c)
    idx = torch.randint(0, t, (1, 4096), generator=g, dtype=torch.int32)
    idx[0, :64] = torch.arange(t - 64, t, dtype=torch.int32)  # the table's last rows
    idx = idx.to(dev)
    out = row_gather(table, idx)
    ref = row_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    del table


def test_row_gather_rejects_bad_inputs(dev):
    table = torch.randn((2, 10, 3), device=dev)
    idx = torch.zeros((2, 4, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        row_gather(table.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        row_gather(table, idx.transpose(1, 2))
    with pytest.raises(ValueError):
        row_gather(table.to(torch.float16), idx)
    with pytest.raises(ValueError):
        row_gather(table, idx.to(torch.int64))
    # the C entry point refuses a variant whose conditions do not hold
    # (cudaErrorInvalidValue = 1) and launches nothing
    from fovealseg_torch.ops.gather import _kernel

    wide = torch.randn((2, 10, 51), device=dev)
    out = torch.empty((2, 20, 51), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    assert _kernel()(wide.data_ptr(), idx.data_ptr(), out.data_ptr(), 2, 20, 10, 51,
                     VARIANT_SMALL, stream) == 1
    odd = _at_offset(torch.zeros((2, 4), dtype=torch.int32), 1, dev)
    assert _kernel()(table.data_ptr(), odd.data_ptr(), out.data_ptr(), 2, 4, 10, 3,
                     VARIANT_SMALL, stream) == 1
    assert _kernel()(table.data_ptr(), odd.data_ptr(), out.data_ptr(), 2, 4, 10, 3,
                     VARIANT_SCALAR, stream) == 0


def test_bf16_warp_on_card_matches_host(dev):
    """The bf16 forward warp rounds after every operation on the card as on
    the host: bit-equal."""
    from fovealseg_torch.core.warp import grid_sample

    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 640, 640, 3)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 80, 80, 2)).astype(np.float32))
    got = grid_sample(img.to(dev).to(torch.bfloat16), grid.to(dev))
    ref = grid_sample(img.to(torch.bfloat16), grid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu().view(torch.int16), ref.view(torch.int16))


def test_tiny_scoremap_slice_on_card_matches_host(dev):
    """The score map and round trips on the card are exactly what the plain
    versions make of the card's own pred and grid; pred and grid match the
    host's within the slice's tolerances."""
    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_prediction_fast
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
    torch.manual_seed(0)
    host = DeformSegmentation(cfg, device="cpu")
    card = DeformSegmentation(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 51, (2, 64, 64)).astype(np.int32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.infer(x.to(dev), f.to(dev), y=y.to(dev), y_sampled_reverse=True,
                         x_sampled_reverse=True)
    ref = host.infer(x, f, y=y, y_sampled_reverse=True, x_sampled_reverse=True)
    torch.testing.assert_close(got["grid"].cpu(), ref["grid"], rtol=0, atol=1e-5)
    pred, grid = got["pred"].cpu(), got["grid"].cpu()
    task_idx, valid = inverse_grid_index(grid, (64, 64))
    host_map = unwarp_prediction_fast(pred, task_idx, valid, None,
                                      jfa_rounds_from_grid(got["grid"], (64, 64)).cpu())
    torch.testing.assert_close(got["pred_sampled"].cpu(), host_map, rtol=0, atol=0)
    for key in ("y_sampled", "y_sampled_reverse", "x_sampled_reverse"):
        assert got[key].shape == ref[key].shape and torch.isfinite(got[key]).all(), key


TINY_EVAL = ["--cfg", "fovealseg_torch/configs/deform.yaml", "--canvas", "64", "--num-batches", "2",
             "TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
             "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny", "MODEL.gaussian_radius", "5",
             "VAL.batch_size", "2", "VAL.y_sampled_reverse", "True", "VAL.dice", "True",
             "VAL.hd95", "True", "VAL.trimap", "True"]


def test_tiny_eval_on_card_matches_host(dev, tmp_path):
    """The eval CLI on the card at the tiny size: each batch's labels and
    label round trip are bit-equal to the host's plain recompute from the
    card's own pred, grid and sampled labels, the card's per-batch
    histograms equal the host metric functions' on those labels integer for
    integer, and the host accumulator over them gives the card's result."""
    from fovealseg_torch.cli import eval as cli
    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.metrics import intersection_and_union
    from fovealseg_torch.core.unwarp import (
        jfa_rounds_from_grid,
        unwarp_argmax_scatter,
        unwarp_labels_fast,
    )

    seen, totals = [], [0, 0]

    def on_batch(out, pred, gt, acc):
        # this batch's histograms: what the card's accumulator gained
        seen.append(({k: v.cpu() for k, v in out.items()}, pred.cpu(), gt.cpu(),
                     (acc.inter - totals[0]).cpu(), (acc.union - totals[1]).cpu()))
        totals[:] = [acc.inter.clone(), acc.union.clone()]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        result = cli.main(TINY_EVAL + ["DIR", str(tmp_path / "card")], on_batch=on_batch)
    assert len(seen) == 2
    host_batches = []
    for out, pred, gt, d_inter, d_union in seen:
        grid = out["grid"]
        rounds = jfa_rounds_from_grid(grid, (64, 64))
        labels = unwarp_argmax_scatter(out["pred"].float(), grid, (64, 64), rounds=rounds)
        torch.testing.assert_close(pred, labels, rtol=0, atol=0)
        task_idx, valid = inverse_grid_index(grid, (64, 64))
        yrev = unwarp_labels_fast(out["y_sampled"][..., None], task_idx, valid, None, rounds)
        torch.testing.assert_close(out["y_sampled_reverse"], yrev[..., 0], rtol=0, atol=0)
        inter, union = intersection_and_union(labels, gt, 51)
        torch.testing.assert_close(d_inter, inter, rtol=0, atol=0)
        torch.testing.assert_close(d_union, union, rtol=0, atol=0)
        host_batches.append((labels, gt, yrev[..., 0]))
    assert cli.accumulate(host_batches, _tiny_eval_cfg(tmp_path / "host")) == result


def _tiny_eval_cfg(out_dir):
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(TINY_EVAL[6:] + ["DIR", str(out_dir)])
    return cfg


def test_tri_device_on_card_matches_host_oracle(dev):
    """The exact 'tri' fill with its sample and blend on the card against the
    port's per-sample host oracle, within 1e-5, on the tiny model's inverse
    warp (64x64 canvas, 16x16 task)."""
    from fovealseg_torch.core.grid import grid_from_index, inverse_grid_index
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.native.interp2d import unwarp_prediction_tri, unwarp_prediction_tri_device

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
    torch.manual_seed(1)
    model = DeformSegmentation(cfg, device=dev)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)).to(dev)
    out = model.infer(x, f)
    task_idx, valid = inverse_grid_index(out["grid"], (64, 64))
    grid_inv = grid_from_index(task_idx, valid, (16, 16))
    got = unwarp_prediction_tri_device(out["pred"].float(), grid_inv, valid)
    assert got.device.type == "cuda" and got.shape == (2, 64, 64, 51)
    ref = unwarp_prediction_tri(out["pred"].float().cpu(), grid_inv.cpu(), valid.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=0, atol=1e-5)


def test_edge_target_on_card_matches_host(dev):
    """The label-edge sampler of MODEL.gt_gradient on the card (full f32, TF32
    off inside) against the host within 1e-6, with the uint8 quantised edges
    equal."""
    from fovealseg_torch.core.edges import edge_target_pil_style, pil_find_edges

    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.integers(0, 51, (2, 8, 8)).astype(np.int32).repeat(80, 1)
                         .repeat(80, 2))
    for softmax, bound in ((False, 1), (True, 0)):
        got = edge_target_pil_style(y.to(dev), (80, 80), (80, 80), 1.0, softmax=softmax,
                                    zero_bound=bound)
        ref = edge_target_pil_style(y, (80, 80), (80, 80), 1.0, softmax=softmax, zero_bound=bound)
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-6)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 40, 48, 1)).astype(np.float32))
    torch.testing.assert_close(pil_find_edges(img.to(dev)).cpu(), pil_find_edges(img),
                               rtol=0, atol=0)


@pytest.mark.parametrize("b,t,c,hw,offset,kind", [
    (8, 6400, 51, (64, 64), 0, "random"), (8, 6400, 1, (640, 640), 0, "random"),
    (2, 4096, 2, (64, 64), 0, "random"), (3, 1000, 3, (33, 70), 0, "random"),
    (1, 5, 300, (9, 9), 0, "random"),
    (2, 700, 4, (40, 40), 0, "random"), (3, 50, 5, (7, 13), 0, "random"),  # C = 4, 5
    (2, 333, 51, (7, 11), 0, "random"),  # ragged N (77 pixels per image)
    (2, 6400, 51, (80, 80), 1, "random"),  # grad_out and idx at an odd storage offset
    (3, 100, 3, (50, 50), 1, "random"),
    (2, 20, 33, (64, 64), 0, "random"),  # T << N: rows of ~200 pixels
    (2, 10, 51, (64, 64), 0, "random"),  # rows of ~400 pixels: the long-row launch
    (1, 3, 33, (100, 100), 1, "random"),  # rows of ~3300 pixels, an odd last channel pair
    (2, 50000, 7, (32, 32), 0, "random"),  # T > N: most rows empty
    (4, 64 * 64, 51, (64, 64), 0, "seeds"),  # the 'BI' shape, small: T = N, seeds every 4th
    (2, 96 * 96, 3, (96, 96), 0, "seeds"),
    (2, 9, 2, (200, 200), 0, "one row"),  # one row takes every pixel: 40000 adds
])
def test_row_gather_backward_bit_equal_to_plain(dev, b, t, c, hw, offset, kind):
    """K5b against ``row_gather_backward_plain``, bit for bit: both sum each
    row's gradient rows in ascending pixel order. Two launches give the same
    bits; indices outside [0, T) are clamped in both; gradients span 16
    orders of magnitude and hold signed zeros."""
    from fovealseg_torch.ops.gather import row_gather_backward, row_gather_backward_plain

    rng = np.random.default_rng(b * t + c + offset)
    if kind == "random":
        idx = rng.integers(-3, t + 3, (b, *hw)).astype(np.int32)
    elif kind == "seeds":  # each pixel's nearest seed on a lattice of step 4, as K4 gives it
        h, w = hw
        y, x = np.meshgrid(np.arange(h) // 4 * 4, np.arange(w) // 4 * 4, indexing="ij")
        idx = np.broadcast_to((y * w + x).astype(np.int32), (b, h, w)).copy()
    else:
        idx = np.full((b, *hw), 4, np.int32)
    g = rng.normal(size=(b, *hw, c)).astype(np.float32)
    g *= (10.0 ** rng.integers(-8, 8, g.shape)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.05] = -0.0
    idx, g = torch.from_numpy(idx), torch.from_numpy(g)
    idx_d, g_d = _at_offset(idx, offset, dev), _at_offset(g, offset, dev)
    before = row_gather_backward.launches
    got = row_gather_backward(g_d, idx_d, t)
    again = row_gather_backward(g_d, idx_d, t)
    torch.cuda.synchronize()
    assert row_gather_backward.launches == before + 2
    ref = row_gather_backward_plain(g, idx, t)
    assert got.shape == (b, t, c) and got.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    assert torch.equal(row_gather_backward_plain(g_d, idx_d, t).cpu().view(torch.int32),
                       ref.view(torch.int32))  # the plain version on the card too


def test_row_gather_gradient_runs_k5b_on_card(dev):
    """A CUDA table that requires grad goes through ``RowGather``: the
    forward launches K5 (bit-equal to the plain gather) and the backward K5b,
    whose gradient is bit-equal to the host's autograd one; a table that does
    not require grad takes no Function."""
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.normal(size=(2, 256, 51)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 256, (2, 64, 64)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(2, 64, 64, 51)).astype(np.float32))
    tc = table.to(dev).requires_grad_(True)
    f0, b0 = row_gather.launches, row_gather_backward_launches()
    out = row_gather(tc, idx.to(dev))
    assert out.grad_fn is not None
    (out * w.to(dev)).sum().backward()
    torch.cuda.synchronize()
    assert row_gather.launches == f0 + 1 and row_gather_backward_launches() == b0 + 1
    th = table.clone().requires_grad_(True)
    ref = row_gather(th, idx)
    (ref * w).sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=0, atol=0)
    assert torch.equal(tc.grad.cpu().view(torch.int32), th.grad.view(torch.int32))
    assert row_gather(table.to(dev), idx.to(dev)).grad_fn is None
    with pytest.raises(ValueError):  # a float64 table has no kernel, with or without grad
        row_gather(torch.zeros((2, 256, 51), dtype=torch.float64, device=dev,
                               requires_grad=True), idx.to(dev))


def row_gather_backward_launches() -> int:
    from fovealseg_torch.ops.gather import row_gather_backward

    return row_gather_backward.launches


def test_row_gather_backward_rejects_bad_inputs(dev):
    from fovealseg_torch.ops.gather import row_gather_backward

    idx = torch.zeros((2, 4, 5), dtype=torch.int32, device=dev)
    g = torch.randn((2, 4, 5, 3), device=dev)
    with pytest.raises(ValueError):
        row_gather_backward(g.to(torch.float16), idx, 10)
    with pytest.raises(ValueError):
        row_gather_backward(g, idx.to(torch.int64), 10)
    with pytest.raises(ValueError):
        row_gather_backward(g.transpose(1, 2), idx.transpose(1, 2), 10)
    with pytest.raises(ValueError):
        row_gather_backward(g[:, :3], idx, 10)


# ---------------------------------------------- the SegFormer, DeepLab, ResNetZoom slice

TINY_MIT = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 24, 32), strides=(1, 2, 2, 2),
                patch_sizes=(7, 3, 3, 3), num_heads=(1, 2, 3, 4), sr_ratios=(8, 4, 2, 1),
                mlp_ratio=4)
ZOOM = ("resnet18", "resnet18_nonsyn", "resnet18_stride1", "resnet10_nonsyn")


def _tiny_net(name):
    """(module, input channels, input size, batch) of a new net at a cut depth."""
    from fovealseg_torch.models.deeplab import DeepLabEncoder
    from fovealseg_torch.models.saliency import ZOOM_NETS, ResNetZoom
    from fovealseg_torch.models.segformer import SegFormerEncoder

    if name == "segformer":
        return SegFormerEncoder(TINY_MIT, drop_path_rate=0.0), 3, 16, 2
    if name == "deeplab":
        return DeepLabEncoder(layers=(1, 1, 1, 1)), 3, 32, 2
    return ResNetZoom(*ZOOM_NETS[name]), 5, 16 if name.endswith("stride1") else 32, 3


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["segformer", "deeplab", *ZOOM])
def test_new_nets_on_card_match_host(dev, name, train):
    """Each new encoder and saliency net at a cut depth, the same seeded
    weights on the card (TF32 off) and on the host, dropout off: the output
    within 1e-4 of its largest magnitude, BN's running statistics after a
    train-mode forward within 1e-4."""
    import copy

    from fovealseg_torch.models import layers

    net, cin, hw, batch = _tiny_net(name)
    host = layers.init_weights(net, torch.Generator().manual_seed(1))
    for m in host.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    card = copy.deepcopy(host).to(dev)
    host.train(train), card.train(train)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(batch, cin, hw, hw))
                         .astype(np.float32))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.no_grad():
        got, ref = card(x.to(dev)), host(x)
    got, ref = (got[0], ref[0]) if isinstance(ref, list) else (got, ref)
    assert float((got.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-4
    for k, v in host.state_dict().items():
        if "running_" in k:
            assert float((card.state_dict()[k].cpu() - v).abs().max()
                         / v.abs().max().clamp(min=1e-30)) <= 1e-4, k


def _cut_slice(monkeypatch, name, **over):
    """The tiny ``DeformSegmentation`` with the cut encoder (``segformer``,
    ``deeplab``) or the tiny HRNet with a ResNetZoom saliency: (host, card)
    with the same seeded weights."""
    from fovealseg_torch.models import builder, layers
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation

    build = builder.build_encoder

    def cut(arch, fc_dim=960, dtype=torch.float32):
        net = _tiny_net(arch)[0] if arch in ("segformer", "deeplab") else None
        return net if net is not None else build(arch, fc_dim, dtype)

    monkeypatch.setattr(builder, "build_encoder", cut)
    arch = {"segformer": ("segformer", 80), "deeplab": ("deeplab", 960)}.get(
        name, ("hrnetv2_nodownsp_tiny", 960))
    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder=arch[0], fc_dim=arch[1],
                       saliency_net=name if name in ZOOM else "fovsimple", **over)
    host = layers.init_weights(DeformSegmentation(cfg, device="cpu"),
                               torch.Generator().manual_seed(3))
    card = DeformSegmentation(cfg, device=torch.device("cuda", 0))
    card.load_state_dict(host.state_dict())
    return host, card


@pytest.mark.parametrize("name", ["segformer", "deeplab", "resnet10_nonsyn"])
def test_new_encoder_slice_on_card(dev, monkeypatch, name):
    """Served labels and score maps with a new encoder or saliency net: K1,
    K2 and K5 launch once per call, and the card's outputs are exactly what
    the plain versions make of the card's own pred and grid; the grid within
    1e-5 of the host's (TF32 off)."""
    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.unwarp import (
        jfa_rounds_from_grid,
        unwarp_argmax_scatter,
        unwarp_prediction_fast,
    )
    from fovealseg_torch.ops.jfa import nearest_payload_packed

    host, card = _cut_slice(monkeypatch, name)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32))
    k1, k2, k5 = nearest_class.launches, nearest_payload_packed.launches, row_gather.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        labels = card.infer(x.to(dev), f.to(dev), argmax_labels=True)
        scores = card.infer(x.to(dev), f.to(dev))
    torch.cuda.synchronize()
    assert (nearest_class.launches - k1, nearest_payload_packed.launches - k2,
            row_gather.launches - k5) == (1, 1, 1)
    ref = host.infer(x, f, argmax_labels=True)
    torch.testing.assert_close(labels["grid"].cpu(), ref["grid"], rtol=0, atol=1e-5)
    grid, pred = labels["grid"].cpu(), labels["pred"].cpu()
    rounds = jfa_rounds_from_grid(grid, (64, 64))
    torch.testing.assert_close(labels["pred_label"].cpu(),
                               unwarp_argmax_scatter(pred, grid, (64, 64), rounds=rounds),
                               rtol=0, atol=0)
    grid, pred = scores["grid"].cpu(), scores["pred"].cpu()
    task_idx, valid = inverse_grid_index(grid, (64, 64))
    host_map = unwarp_prediction_fast(pred, task_idx, valid, None,
                                      jfa_rounds_from_grid(grid, (64, 64)))
    assert torch.equal(scores["pred_sampled"].cpu().view(torch.int32), host_map.view(torch.int32))


@pytest.mark.parametrize("name", ["segformer", "deeplab"])
def test_spatial_encoder_pair_on_card(dev, monkeypatch, name):
    """Row-partitioned serving with a cut encoder: two gloo ranks on the one
    card give one process's labels on the card wherever its scores decide
    them (top-two margin > 1e-4), K1 once on each rank."""
    import torch_parallel_workers as W
    from fovealseg_torch.parallel.launch import run_workers

    host, card = _cut_slice(monkeypatch, name)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.no_grad():
        xt, ft = torch.from_numpy(x).to(dev), torch.from_numpy(f).to(dev)
        scores = card.infer(xt, ft)["pred_sampled"].cpu()
        want = card.infer(xt, ft, argmax_labels=True)["pred_label"].cpu()
    ranks = run_workers(2, W.spatial_pair_on_card, host.state_dict(), host.config, TINY_MIT, x, f,
                        device=[0, 0], backend="gloo", timeout=300)
    top2 = torch.sort(scores, dim=-1).values[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert decided.float().mean() > 0.5
    for r in ranks:
        assert r["k1"] == 1
        assert torch.equal(r["label"][decided], want[decided])


@pytest.mark.parametrize("name", ["segformer", "deeplab"])
def test_new_encoder_high_res_step_on_card(dev, monkeypatch, name):
    """One ``MODEL.loss_at_high_res`` 'nearest' train step with a new
    encoder, dropout off, on the card (TF32 off), on the host and on the host
    with float64 sub-networks: K2, K5 and K5b launch once each; the loss
    within 1e-4 of the host's; the saliency nets' gradient (which reaches
    them only through K5b) non-zero, within 5% of the host's with SegFormer,
    and with either encoder no farther from the float64 gradient than twice
    the host f32 gradient's distance plus 1e-3 of its norm (the tiny model's
    sensitivity, ``tests/test_torch_port_train.py``: DeepLab's train-mode
    BN normalises layer4's 2x2 map over 8 values per channel, so the f32
    noise itself sets the bound)."""
    from fovealseg_torch.configs import get_default_cfg
    from fovealseg_torch.data.synthetic import make_batch
    from fovealseg_torch.models import layers
    from fovealseg_torch.ops import gather
    from fovealseg_torch.ops.jfa import nearest_payload_packed
    from fovealseg_torch.train import step as S
    from fovealseg_torch.train.optim import create_optimizer, make_stage_schedules

    arch, fc_dim = {"segformer": ("segformer", 80), "deeplab": ("deeplab", 960)}[name]
    cfg = get_default_cfg()
    cfg.merge_from_file("fovealseg_torch/configs/deform.yaml")
    cfg.merge_from_list(["TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size",
                         "(16,16)", "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", arch,
                         "MODEL.fc_dim", str(fc_dim), "MODEL.loss_at_high_res", "True"])
    cfg.TRAIN.max_iters = cfg.TRAIN.epoch_iters * cfg.TRAIN.num_epoch
    host, card = _cut_slice(monkeypatch, name, loss_at_high_res=True)
    batch = make_batch(np.random.default_rng(5), 2, canvas=64)
    runs = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for model in (host, card, _float64_nets(host)):
            for m in model.modules():
                if isinstance(m, layers.Dropout):
                    m.p = 0.0
            d = next(model.parameters()).device
            state = S.init_state(model, create_optimizer(cfg, model), 0)
            step = S.make_train_step(S.LossConfig.from_cfg(cfg), make_stage_schedules(cfg))
            before = (nearest_payload_packed.launches, row_gather.launches,
                      gather.row_gather_backward.launches)
            loss = float(step(state, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
                         ["loss"])
            torch.cuda.synchronize()
            launched = (nearest_payload_packed.launches - before[0],
                        row_gather.launches - before[1],
                        gather.row_gather_backward.launches - before[2])
            sal = torch.cat([p.grad.detach().cpu().reshape(-1)
                             for sub in (model.localization, model.net_compress)
                             for p in sub.parameters() if p.grad is not None])
            runs.append((loss, sal, launched))
    (h_loss, h_sal, _), (c_loss, c_sal, launched), (_, f_sal, _) = runs
    assert launched == (1, 1, 1)
    assert abs(c_loss - h_loss) <= 1e-4 * abs(h_loss)
    assert float(c_sal.norm()) > 0
    if name == "segformer":
        assert float((c_sal - h_sal).norm() / h_sal.norm()) <= 0.05
    card64, host64 = float((c_sal.double() - f_sal).norm()), float((h_sal.double() - f_sal).norm())
    assert card64 <= 2 * host64 + 1e-3 * float(f_sal.norm()), (card64, host64)


def _float64_nets(model):
    """A copy of ``model`` whose sub-networks hold f64 weights and compute in
    f64; the geometry between them stays f32 (``chip_smoke.py::float64_nets``)."""
    import copy

    m = copy.deepcopy(model).double()
    for sub in m.modules():
        if hasattr(sub, "compute_dtype"):
            sub.compute_dtype = torch.float64
    return m


def test_odgt_record_kernels_bit_equal_to_plain(dev):
    """One ODGT-shaped record on the card (375x501 canvas, odd H*W, two
    pyramid levels, 150 classes, the label round trip on): every K2 and K5
    launch of ``eval_odgt.evaluate_record`` (K5 at C = 150 and C = 1) is
    bit-equal to its plain version on the inputs it was given, and the
    record's labels equal the host's from the same weights where the host's
    scores have a top-two margin above 1e-4."""
    from fovealseg_torch.cli import eval_odgt
    from fovealseg_torch.core import unwarp
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=150, arch_encoder="hrnetv2_nodownsp_tiny")
    rng = np.random.default_rng(5)
    rec = {"img_data": [rng.normal(size=(1, h, w, 3)).astype(np.float32)
                        for h, w in ((288, 384), (384, 512))],
           "seg_label": rng.integers(-1, 150, (1, 47, 63)).repeat(8, 1).repeat(8, 2)[:, :375,
                                                                                     :501]}
    calls = {"nearest_payload_packed": [], "row_gather": []}
    saved = {name: getattr(unwarp, name) for name in calls}

    def recording(name):
        def call(*args):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return saved[name](*args)
        return call

    outs = {}
    for d in (dev, torch.device("cpu")):
        model = init_weights(DeformSegmentation(cfg, device=d), torch.Generator().manual_seed(3))
        try:
            for name in calls:
                setattr(unwarp, name, recording(name) if d.type == "cuda" else saved[name])
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                res = eval_odgt.evaluate_record(model, rec, (0.45, 0.55), d, rev_y=True)
        finally:
            for name, fn in saved.items():
                setattr(unwarp, name, fn)
        outs[d.type] = {k: v.cpu() for k, v in res.items()}
    assert len(calls["nearest_payload_packed"]) == 4 and len(calls["row_gather"]) == 4
    assert sorted(a[0].shape[-1] for a in calls["row_gather"]) == [1, 1, 150, 150]
    for args in calls["nearest_payload_packed"]:
        got = jfa.nearest_payload_packed(*args)
        torch.testing.assert_close(got, jfa.nearest_payload_packed_plain(*args), rtol=0, atol=0)
        assert args[0].shape == (1, 375, 501)
    for args in calls["row_gather"]:
        got = row_gather(*args)
        assert torch.equal(got.view(torch.int32), row_gather_plain(*args).view(torch.int32))
    card, host = outs["cuda"], outs["cpu"]
    top2 = torch.sort(host["scores"][0], dim=-1).values[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert decided.float().mean() > 0.5
    assert torch.equal(card["pred"][decided], host["pred"][decided])


def test_train_cli_on_cooked_lvis_on_card(dev, tmp_path):
    """``cli.train --data``: one step on a cooked LVIS set on the card (3
    samples at batch 2 reconcile ``TRAIN.epoch_iters`` to 1), the batches
    read into pinned memory and copied without blocking."""
    from fovealseg_torch.cli import cook
    from fovealseg_torch.cli import train as train_cli
    from torch_port_files import lvis_json

    j, root = lvis_json(str(tmp_path / "l.json")), tmp_path / "cook"
    for part, n in (("train", 3), ("valid", 10)):
        assert cook.main(["lvis", f"--{part}-json", j, "--dataset-partition", part,
                          "--out", str(root), "--sample-num", str(n), "--canvas", "64"]) == 0
    state = train_cli.main([
        "--cfg", "fovealseg_torch/configs/deform.yaml", "--canvas", "64", "--data", str(root),
        "TRAIN.task_input_size", "(16,16)", "TRAIN.saliency_input_size", "(16,16)",
        "MODEL.gaussian_radius", "5", "MODEL.arch_encoder", "hrnetv2_nodownsp_tiny",
        "TRAIN.batch_size_per_gpu", "2", "TRAIN.num_epoch", "1", "TPU.compute_dtype", "float32",
        "DATASET.dataset_marker_train", "sp3", "DATASET.dataset_marker_valid", "sp2",
        "DIR", str(tmp_path / "run")])
    assert state.step == 1
    assert next(state.model.parameters()).device.type == "cuda"
    assert (tmp_path / "run" / "encoder_epoch_1.pth").exists()


# ---------------------------------------------- the registered operators and the artifact

def _op_cases_on(dev):
    g = torch.Generator().manual_seed(0)
    valid = torch.rand((2, 96, 80), generator=g) > 0.97
    pay = torch.randint(0, 50, (2, 96, 80), generator=g, dtype=torch.int32)
    idx = torch.randint(-2, 300, (2, 16, 20), generator=g, dtype=torch.int32)
    cases = {"nearest_class": (valid, pay, torch.tensor([5], dtype=torch.int32)),
             "nearest_payload_packed": (valid, pay, torch.tensor([5], dtype=torch.int32)),
             "nearest_payload": (valid, pay, torch.tensor([5], dtype=torch.int32)),
             "nearest_seed": (valid, torch.tensor([5], dtype=torch.int32)),
             "row_gather": (torch.randn((2, 298, 51), generator=g), idx),
             "row_gather_backward": (torch.randn((2, 16, 20, 51), generator=g), idx, 298)}
    return {k: tuple(a.to(dev) if torch.is_tensor(a) else a for a in v) for k, v in cases.items()}


@pytest.mark.parametrize("name", ["nearest_class", "nearest_payload_packed", "nearest_payload",
                                  "nearest_seed", "row_gather", "row_gather_backward"])
def test_opcheck_on_card(dev, name):
    """``torch.library.opcheck`` of each registered operator on CUDA tensors
    (the fake kernel against the CUDA kernel), which launches the kernel and
    counts it, bit-equal to the CPU kernel on the same inputs."""
    import fovealseg_torch.ops  # noqa: F401
    from fovealseg_torch.ops import gather

    args = _op_cases_on(dev)[name]
    op = getattr(torch.ops.fovealseg, name).default
    torch.library.opcheck(op, args)
    counter = getattr(jfa, name, None) or getattr(gather, name)
    before = counter.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    host = op(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    assert torch.equal(got.cpu().view(torch.int32), host.view(torch.int32))


@pytest.mark.parametrize("scores", [False, True], ids=["labels", "scores"])
def test_tiny_artifact_on_card_bit_equal_to_live(dev, tmp_path, scores):
    """The tiny flagship exported on the card: the loaded program's labels
    (or scores) bit-equal to the live ``infer``, and its run launches K1
    (or K2 and K5) once, counted by the operators' CUDA kernels."""
    from fovealseg_torch.cli import export
    from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
    from fovealseg_torch.models.layers import init_weights
    from fovealseg_torch.ops import gather

    cfg = DeformConfig(task_hw=(16, 16), task_hw_infer=(16, 16), saliency_hw=(16, 16),
                       gaussian_radius=5, num_class=51, arch_encoder="hrnetv2_nodownsp_tiny")
    model = init_weights(DeformSegmentation(cfg, device=dev), torch.Generator().manual_seed(3))
    program = export.export_serving(model, 2, 64, scores=scores)
    assert export.kernel_ops(program) == (["nearest_payload_packed", "row_gather"] if scores
                                          else ["nearest_class"])
    assert program.constants and all(t.device.type == "cuda" for t in program.constants.values())
    torch.export.save(program, str(tmp_path / "p.pt2"))
    serve = torch.export.load(str(tmp_path / "p.pt2")).module()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 2)).astype(np.float32)).to(dev)
    counters = (nearest_class, jfa.nearest_payload_packed, gather.row_gather)
    before = [c.launches for c in counters]
    got = serve(x, f)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [0, 1, 1] if scores else [1, 0, 0])
    want = model.infer(x, f, argmax_labels=not scores)["pred_sampled" if scores else "pred_label"]
    assert got.device.type == "cuda" and torch.equal(got, want)


def test_deformed_sampler_on_card_matches_host(dev):
    """The DynamicFocus sampler on the card: ``get_grid`` within 1e-5 of the
    host's f32 result (TF32 on, as the train CLI sets it: the products must
    stay full f32), ``int_round_scale_grid`` equal, and ``deformed_unsampler``
    bit-equal to its CPU run, launching K4 and K5 once each."""
    from fovealseg_torch.core import deformed_sampler as ds
    from fovealseg_torch.ops import gather

    rng = np.random.default_rng(12)
    k, hs = 15, 20
    dm = torch.from_numpy(rng.uniform(0, 1, (2, hs + k - 1, hs + k - 1, 1)).astype(np.float32))
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        grid = ds.get_grid(dm.to(dev), (hs, hs), kernel_size=k)
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev
    ref_grid = ds.get_grid(dm, (hs, hs), kernel_size=k)
    torch.testing.assert_close(grid.cpu(), ref_grid, rtol=1e-5, atol=1e-5)
    ig = ds.int_round_scale_grid(ref_grid, (96, 96))
    assert torch.equal(ds.int_round_scale_grid(ref_grid.to(dev), (96, 96)).cpu(), ig)
    values = torch.from_numpy(rng.normal(size=(2, hs, hs, 5)).astype(np.float32))
    before = (jfa.nearest_seed.launches, gather.row_gather.launches)
    got = ds.deformed_unsampler(values.to(dev), ig.to(dev), (96, 96))
    torch.cuda.synchronize()
    assert (jfa.nearest_seed.launches - before[0], gather.row_gather.launches - before[1]) == (1, 1)
    want = ds.deformed_unsampler(values, ig, (96, 96))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_async_saver_with_card_tensors(dev, tmp_path):
    """``AsyncSaver`` on a state on the card: pinned snapshot buffers for the
    card's tensors, files that load bit-equal to the synchronous write's, and
    the snapshot taken at ``save()`` although the parameters change right
    after it."""
    import random

    from fovealseg_torch.train import checkpoint as ckpt
    from fovealseg_torch.train.step import TrainState

    torch.manual_seed(0)
    model = torch.nn.ModuleDict({n: torch.nn.Linear(64, 32) for n in ckpt.SUBMODULE_OF_FILE.values()})
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.1, foreach=True)
    sum(m(torch.ones(4, 64, device=dev)).sum() for m in model.values()).backward()
    opt.step()
    state = TrainState(model, opt, 1, torch.Generator(device=dev).manual_seed(1), random.Random(1))
    ckpt.save_checkpoint(str(tmp_path / "sync"), 1, state)
    saver = ckpt.AsyncSaver()
    ckpt.save_checkpoint(str(tmp_path / "async"), 1, state, saver=saver)
    # every snapshot of a card tensor is pinned (Adam's step count lives on the host)
    assert all(b.is_pinned() == (k[-1] != "step") for k, b in saver._buffers.items())
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    saver.close()
    for tag in (1, "last"):
        for kind in (*ckpt.SUBMODULE_OF_FILE, "train_state"):
            a = torch.load(tmp_path / "sync" / f"{kind}_epoch_{tag}.pth", map_location="cpu",
                           weights_only=True)
            b = torch.load(tmp_path / "async" / f"{kind}_epoch_{tag}.pth", map_location="cpu",
                           weights_only=True)
            if kind == "train_state":
                a, b = a["optimizer"]["state"], b["optimizer"]["state"]
                a = {(i, n): v for i, e in a.items() for n, v in e.items()}
                b = {(i, n): v for i, e in b.items() for n, v in e.items()}
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a), (kind, tag)
