"""Saliency ("foveater") networks and the compress head (counterpart of
``fovealseg_tpu/models/saliency.py``). NCHW.

* ``FovSimModule`` (``fovsimple``): 3-conv saliency CNN, 5 -> 24 channels.
* ``ResNetZoom`` (``resnet18``, ``resnet18_nonsyn``, ``resnet18_stride1``,
  ``resnet10_nonsyn``): a BasicBlock ResNet stem and layer1..layer3 only,
  256 channels out (stride 16, or 1 for ``stride1``). The ``_nonsyn`` nets
  normalise with the current batch's statistics in eval too
  (``layers.BatchStatsNorm``), so a served frame's saliency depends on the
  other frames of its batch: the reference's semantics, not a fault.
* ``CompressNet``: ReLU and a 1x1 conv to one saliency channel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import BatchStatsNorm, batch_norm, conv2d, relu6


class FovSimModule(nn.Module):
    """fov_simple: expand(5 -> 8*out) -> expand -> squeeze(-> out), ReLU6 + BN."""

    def __init__(self, in_channels: int = 5, out_channels: int = 24,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = 8 * out_channels
        self.fov_expand_1 = conv2d(in_channels, c, 3, 1, 1, use_bias=False, dtype=dtype)
        self.norm1 = batch_norm(c, dtype)
        self.fov_expand_2 = conv2d(c, c, 3, 1, 1, use_bias=False, dtype=dtype)
        self.norm2 = batch_norm(c, dtype)
        self.fov_squeeze_1 = conv2d(c, out_channels, 3, 1, 1, use_bias=False, dtype=dtype)
        self.norm3 = batch_norm(out_channels, dtype)

    def forward(self, x):
        x = relu6(self.norm1(self.fov_expand_1(x)))
        x = relu6(self.norm2(self.fov_expand_2(x)))
        return self.norm3(self.fov_squeeze_1(x))


class CompressNet(nn.Module):
    """ReLU then 1x1 conv to a scalar saliency channel."""

    def __init__(self, in_channels: int = 24, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_last = conv2d(in_channels, 1, 1, 1, 0, dtype=dtype)

    def forward(self, x):
        return self.conv_last(torch.relu(x))


def _zoom_bn(channels: int, dtype, nonsyn: bool) -> nn.Module:
    return BatchStatsNorm(channels, dtype) if nonsyn else batch_norm(channels, dtype)


class ZoomBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool,
                 dtype=torch.float32, nonsyn: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1, use_bias=False, dtype=dtype)
        self.bn1 = _zoom_bn(planes, dtype, nonsyn)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = _zoom_bn(planes, dtype, nonsyn)
        self.downsample = (nn.Sequential(conv2d(inplanes, planes, 1, stride, 0, use_bias=False,
                                                dtype=dtype),
                                         _zoom_bn(planes, dtype, nonsyn))
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetZoom(nn.Module):
    """ResNet-18/10 saliency trunk: 7x7 stem, BN, ReLU, 3x3 max pool, then
    layer1..layer3 (64, 128, 256 channels). ``stride1`` keeps the stem, the
    pool and every stage at stride 1; ``nonsyn`` uses ``BatchStatsNorm``."""

    def __init__(self, layers=(2, 2, 2, 2), stride1: bool = False, nonsyn: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.pool_stride = 1 if stride1 else 2
        self.conv1 = conv2d(5, 64, 7, self.pool_stride, 3, use_bias=False, dtype=dtype)
        self.bn1 = _zoom_bn(64, dtype, nonsyn)
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256), layers[:3], (1, 1, 1) if stride1 else (1, 2, 2))):
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                seq.append(ZoomBasicBlock(inplanes, planes, s, s != 1 or inplanes != planes,
                                          dtype, nonsyn))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.max_pool2d(x, 3, self.pool_stride, 1)
        return self.layer3(self.layer2(self.layer1(x)))


# name -> (layers, stride1, nonsyn), as the JAX package's build_saliency
ZOOM_NETS = {
    "resnet18": ((2, 2, 2, 2), False, False),
    "resnet18_nonsyn": ((2, 2, 2, 2), False, True),
    "resnet18_stride1": ((2, 2, 2, 2), True, False),
    "resnet10_nonsyn": ((1, 1, 1, 1), False, True),
}
