"""Port on the card: the CUDA kernels against their plain versions.

Marked ``cuda``; each test skips without a CUDA device (decided in the
fixture, never at import). Run on a machine with a card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
