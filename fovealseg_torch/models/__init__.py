from fovealseg_torch.models.backbones import build_backbone
from fovealseg_torch.models.builder import (
    build_decoder,
    build_encoder,
    build_net_compress,
    build_net_saliency,
)
from fovealseg_torch.models.deform_module import DeformConfig, DeformSegmentation
from fovealseg_torch.models.legacy_decoders import build_legacy_decoder
from fovealseg_torch.models.seg_hrnet import SegHRNet, get_seg_model
from fovealseg_torch.models.segmentation_module import SegmentationModule

__all__ = [
    "build_backbone",
    "get_seg_model",
    "SegHRNet",
    "build_decoder",
    "build_encoder",
    "build_legacy_decoder",
    "build_net_compress",
    "build_net_saliency",
    "DeformConfig",
    "DeformSegmentation",
    "SegmentationModule",
]
