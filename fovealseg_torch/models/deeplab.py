"""DeepLabV3-ResNet101 encoder rewired to 960 output channels (counterpart of
``fovealseg_tpu/models/deeplab.py``).

torchvision's ``deeplabv3_resnet101`` as the reference wraps it: ResNet-101 at
output stride 8 (layers 3 and 4 dilated; the first block of a dilated layer
keeps the previous dilation), the ASPP head (a 1x1 branch, 3x3 branches at
rates 12/24/36 with padding equal to the rate, an image-pool branch, a 1x1
projection, Dropout(0.5)), and the classifier tail rewired 256 -> 512 ->
``num_classes`` (960) so that the module is an encoder for the shared C1
decoder. The output is resized to the input's size in f32 and cast back.
NCHW. Module paths follow torchvision under ``deeplab.backbone.*`` and
``deeplab.classifier.*``; BN is the port's flax-semantics ``BatchNorm2d``.
The stem's max pool, the image pool's mean and the output resize go through
``layers.trunk_max_pool`` / ``trunk_mean`` / ``trunk_resize``, so that the
same forward runs row-partitioned (``parallel/spatial.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import (
    Dropout,
    at_least_f32,
    batch_norm,
    conv2d,
    trunk_max_pool,
    trunk_mean,
    trunk_resize,
    whole_tensors,
)

RESNET101_LAYERS = (3, 4, 23, 3)


class TVBottleneck(nn.Module):
    """torchvision ResNet Bottleneck (1x1, dilated 3x3 carrying the stride, 1x1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(planes, dtype)
        self.conv2 = conv2d(planes, planes, 3, stride, dilation, use_bias=False, dtype=dtype,
                            dilation=dilation)
        self.bn2 = batch_norm(planes, dtype)
        self.conv3 = conv2d(planes, planes * 4, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn3 = batch_norm(planes * 4, dtype)
        self.downsample = (nn.Sequential(conv2d(inplanes, planes * 4, 1, stride, 0, use_bias=False,
                                                dtype=dtype),
                                         batch_norm(planes * 4, dtype))
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet101OS8(nn.Module):
    """ResNet-101 with ``replace_stride_with_dilation=[False, True, True]``;
    ``layers`` can be cut for tests."""

    def __init__(self, dtype=torch.float32, layers=RESNET101_LAYERS):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, 2, 3, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(64, dtype)
        inplanes, dilation = 64, 1
        for li, (planes, blocks, stride, dilate) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2), (False, False, True, True))):
            prev_dilation = dilation
            if dilate:
                dilation *= stride
                stride = 1
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes * 4)
                seq.append(TVBottleneck(inplanes, planes, s, prev_dilation if b == 0 else dilation,
                                        ds, dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = trunk_max_pool(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def _conv_bn_relu(cin: int, cout: int, k: int, rate: int, dtype) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, k, 1, rate if k == 3 else 0, use_bias=False,
                                dtype=dtype, dilation=rate),
                         batch_norm(cout, dtype), nn.ReLU())


class _ImagePool(nn.Module):
    """The mean over H and W (torchvision's ``AdaptiveAvgPool2d(1)``)."""

    def forward(self, x):
        return trunk_mean(x, keepdim=True)


class _PoolBranch(nn.Sequential):
    """The image-pool branch (``_ImagePool``, 1x1 conv, BN, ReLU). Every rank
    of a row-partitioned trunk holds the pooled vector whole, so the layers
    after the pool take no row blocks."""

    def forward(self, x):
        x = self[0](x)
        with whole_tensors():
            for layer in self[1:]:
                x = layer(x)
        return x


class ASPP(nn.Module):
    """torchvision ASPP to 256 channels: ``convs.0`` (1x1), ``convs.1-3``
    (atrous at rates 12, 24, 36), ``convs.4`` (image pool, 1x1, BN, ReLU),
    ``project`` (1x1, BN, ReLU, Dropout(0.5))."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            [_conv_bn_relu(cin, 256, 1, 1, dtype)]
            + [_conv_bn_relu(cin, 256, 3, r, dtype) for r in (12, 24, 36)]
            + [_PoolBranch(_ImagePool(), *_conv_bn_relu(cin, 256, 1, 1, dtype))])
        self.project = nn.Sequential(conv2d(5 * 256, 256, 1, 1, 0, use_bias=False, dtype=dtype),
                                     batch_norm(256, dtype), nn.ReLU(), Dropout(0.5))

    def forward(self, x):
        branches = [conv(x) for conv in self.convs[:-1]]
        gp = self.convs[-1](x)
        branches.append(gp.expand(-1, -1, *branches[0].shape[-2:]))
        return self.project(torch.cat(branches, dim=1))


class DeepLabEncoder(nn.Module):
    """Backbone + ASPP + the rewired 256 -> 512 -> ``num_classes`` tail;
    returns ``[features]`` [B, num_classes, H, W]."""

    def __init__(self, num_classes: int = 960, dtype=torch.float32, layers=RESNET101_LAYERS):
        super().__init__()
        self.dtype = dtype
        self.deeplab = nn.Module()
        self.deeplab.backbone = ResNet101OS8(dtype, layers)
        self.deeplab.classifier = nn.Sequential(
            ASPP(2048, dtype=dtype), conv2d(256, 512, 1, 1, 0, dtype=dtype),
            batch_norm(512, dtype), nn.ReLU(), conv2d(512, num_classes, 1, 1, 0, dtype=dtype))

    def forward(self, x):
        out = self.deeplab.classifier(self.deeplab.backbone(x))
        return [trunk_resize(at_least_f32(out), tuple(x.shape[-2:])).to(self.dtype)]
