"""Model registry (counterpart of ``fovealseg_tpu/models/builder.py``):
encoders ``hrnetv2_nodownsp[_tiny]``, ``segformer`` and ``deeplab``, decoder
``c1``, saliency nets ``fovsimple`` and the four ResNetZoom nets, and the
compress net. Any other name raises, naming what is ported."""

from __future__ import annotations

import torch

ENCODERS = ("hrnetv2_nodownsp", "hrnetv2_nodownsp_tiny", "segformer", "deeplab")
SALIENCY_NETS = ("fovsimple", "resnet18", "resnet18_nonsyn", "resnet18_stride1",
                 "resnet10_nonsyn")


def build_encoder(arch: str = "hrnetv2_nodownsp", fc_dim: int = 960, dtype=torch.float32):
    """The encoder ``arch``. As in the JAX package, ``fc_dim`` is the
    decoder's input width and no encoder reads it: SegFormer-B5 gives 1024
    channels, DeepLab and HRNetV2 960."""
    arch = arch.lower()
    if arch == "hrnetv2_nodownsp":
        from fovealseg_torch.models.hrnet import HRNetV2NoDownsp

        return HRNetV2NoDownsp(dtype=dtype)
    if arch == "hrnetv2_nodownsp_tiny":
        from fovealseg_torch.models.hrnet import HRNetV2NoDownsp

        # structurally identical reduced-depth variant (tests, smokes)
        return HRNetV2NoDownsp(dtype=dtype, stage_modules=(1, 1, 1), num_blocks=1, layer1_blocks=1)
    if arch == "segformer":
        from fovealseg_torch.models.segformer import SegFormerEncoder

        return SegFormerEncoder(dtype=dtype)
    if arch == "deeplab":
        from fovealseg_torch.models.deeplab import DeepLabEncoder

        return DeepLabEncoder(dtype=dtype)
    raise ValueError(f"encoder {arch!r} is not ported (ported: {', '.join(ENCODERS)})")


def build_decoder(arch: str = "c1", fc_dim: int = 960, num_class: int = 51, dtype=torch.float32):
    from fovealseg_torch.models.c1 import C1

    if arch.lower() == "c1":
        return C1(num_class=num_class, fc_dim=fc_dim, dtype=dtype)
    raise ValueError(f"decoder {arch!r} is not ported (c1 only)")


def build_net_saliency(name: str = "fovsimple", dtype=torch.float32):
    from fovealseg_torch.models.saliency import ZOOM_NETS, FovSimModule, ResNetZoom

    if name == "fovsimple":
        return FovSimModule(dtype=dtype)
    if name in ZOOM_NETS:
        layers, stride1, nonsyn = ZOOM_NETS[name]
        return ResNetZoom(layers, stride1, nonsyn, dtype)
    raise ValueError(f"saliency net {name!r} is not ported (ported: {', '.join(SALIENCY_NETS)})")


def build_net_compress(saliency_net: str = "fovsimple", dtype=torch.float32):
    from fovealseg_torch.models.saliency import CompressNet

    return CompressNet(in_channels=24 if saliency_net == "fovsimple" else 256, dtype=dtype)
