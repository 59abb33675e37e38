"""Model registry (counterpart of ``fovealseg_tpu/models/builder.py``) for the
archs this slice ports: encoders ``hrnetv2_nodownsp[_tiny]``, decoder ``c1``,
saliency ``fovsimple``. Any other arch raises."""

from __future__ import annotations

import torch


def build_encoder(arch: str = "hrnetv2_nodownsp", fc_dim: int = 960, dtype=torch.float32):
    from fovealseg_torch.models.hrnet import HRNetV2NoDownsp

    arch = arch.lower()
    if arch == "hrnetv2_nodownsp":
        return HRNetV2NoDownsp(dtype=dtype)
    if arch == "hrnetv2_nodownsp_tiny":
        # structurally identical reduced-depth variant (tests, smokes)
        return HRNetV2NoDownsp(dtype=dtype, stage_modules=(1, 1, 1), num_blocks=1, layer1_blocks=1)
    raise ValueError(f"encoder {arch!r} is not ported (hrnetv2_nodownsp[_tiny] only)")


def build_decoder(arch: str = "c1", fc_dim: int = 960, num_class: int = 51, dtype=torch.float32):
    from fovealseg_torch.models.c1 import C1

    if arch.lower() == "c1":
        return C1(num_class=num_class, fc_dim=fc_dim, dtype=dtype)
    raise ValueError(f"decoder {arch!r} is not ported (c1 only)")


def build_net_saliency(name: str = "fovsimple", dtype=torch.float32):
    from fovealseg_torch.models.saliency import FovSimModule

    if name == "fovsimple":
        return FovSimModule(dtype=dtype)
    raise ValueError(f"saliency net {name!r} is not ported (fovsimple only)")


def build_net_compress(saliency_net: str = "fovsimple", dtype=torch.float32):
    from fovealseg_torch.models.saliency import CompressNet

    return CompressNet(in_channels=24 if saliency_net == "fovsimple" else 256, dtype=dtype)
