"""Stock backbones with the dilated feature-extractor wrappers (counterpart of
``fovealseg_tpu/models/backbones.py``): the MIT-scene-parsing ResNet-18/50/101
and ResNeXt-101 (3-conv stem), ``MobileNetV2Dilated`` and the registry
``build_backbone``. NCHW.

As in the JAX package, the reference's own builder reaches none of these
(``models/builder.py`` keeps raising for them); they pair with the legacy
decoders (``models/legacy_decoders.py``). Each returns the feature pyramid,
a list of NCHW maps ([layer1..layer4]; MobileNetV2: after features 2, 4, 7,
14 and the last), or ``[last]`` with ``return_feature_maps=False``.

The dilation surgery (``_nostride_dilate``): a conv that had stride 2
becomes stride 1 with dilation ``dilate // 2``, every other 3x3 conv of the
dilated stage gets ``dilate``; 1x1 convs (the downsample too) only lose the
stride. Module names follow the torch state dict (``conv1``, ``layer1.0``,
``features.{i}.conv.{j}``), as the JAX package's export writes them. Weights
are random from an explicit generator (``layers.init_weights``); no
pretrained weights are loaded.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fovealseg_torch.models.layers import batch_norm, conv2d, relu6


def _conv3x3(cin: int, cout: int, stride: int, dilation: int, dtype, groups: int = 1):
    # a plain nn.Conv in the JAX package (its _dilated_conv3x3, Bottleneck conv2 and
    # MobileNetV2's depthwise conv): TPU.quantize leaves it alone
    return conv2d(cin, cout, 3, stride, dilation, use_bias=False, dtype=dtype,
                  dilation=dilation, groups=groups, quantizable=False)


def _downsample(cin: int, cout: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, 1, stride, 0, use_bias=False, dtype=dtype),
                         batch_norm(cout, dtype))


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool,
                 dil1: int, dil2: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride, dil1, dtype)
        self.bn1 = batch_norm(planes, dtype)
        self.conv2 = _conv3x3(planes, planes, 1, dil2, dtype)
        self.bn2 = batch_norm(planes, dtype)
        self.downsample = _downsample(inplanes, planes, stride, dtype) if has_downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _Bottleneck(nn.Module):
    """1x1, 3x3 (dilated, grouped for ResNeXt: expansion 2), 1x1."""

    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool,
                 dil2: int, groups: int = 1, dtype=torch.float32):
        super().__init__()
        out = planes * (2 if groups > 1 else 4)
        self.conv1 = conv2d(inplanes, planes, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(planes, dtype)
        self.conv2 = _conv3x3(planes, planes, stride, dil2, dtype, groups)
        self.bn2 = batch_norm(planes, dtype)
        self.conv3 = conv2d(planes, out, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn3 = batch_norm(out, dtype)
        self.downsample = _downsample(inplanes, out, stride, dtype) if has_downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class MITResNet(nn.Module):
    """MIT-scene-parsing ResNet/ResNeXt trunk: 3-conv stem (64, 64, 128),
    max pool, four stages. ``block``: 'basic', 'bottleneck' or 'group'
    (ResNeXt, ``groups`` wide); ``dilate_scale`` 0 (off), 8 (layer3 and
    layer4 dilated 2 and 4) or 16 (layer4 dilated 2)."""

    def __init__(self, block: str = "bottleneck", layers=(3, 4, 6, 3), groups: int = 1,
                 dilate_scale: int = 0, dtype=torch.float32):
        super().__init__()
        self.conv1 = conv2d(3, 64, 3, 2, 1, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(64, dtype)
        self.conv2 = conv2d(64, 64, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = batch_norm(64, dtype)
        self.conv3 = conv2d(64, 128, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn3 = batch_norm(128, dtype)
        if block == "group":
            stage_planes, expansion = (128, 256, 512, 1024), 2
        else:
            stage_planes, expansion = (64, 128, 256, 512), 4 if block == "bottleneck" else 1
        strides, dilates = [1, 2, 2, 2], [1, 1, 1, 1]
        if dilate_scale == 8:
            strides[2:], dilates[2:] = [1, 1], [2, 4]
        elif dilate_scale == 16:
            strides[3], dilates[3] = 1, 2
        inplanes = 128
        for si, (planes, blocks) in enumerate(zip(stage_planes, layers)):
            stage = []
            for b in range(blocks):
                s, d = (strides[si] if b == 0 else 1), dilates[si]
                # the conv that carried the removed stride gets dilate // 2
                first_d = max(d // 2, 1) if (b == 0 and strides[si] == 1 and d > 1) else d
                needs_ds = b == 0 and (strides[si] != 1 or inplanes != planes * expansion)
                if block == "basic":
                    stage.append(_BasicBlock(inplanes, planes, s, needs_ds, first_d, d, dtype))
                else:
                    stage.append(_Bottleneck(inplanes, planes, s, needs_ds, first_d, groups,
                                             dtype))
                inplanes = planes * expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))

    def forward(self, x, return_feature_maps: bool = True):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = torch.relu(self.bn3(self.conv3(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        conv_out = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            conv_out.append(x)
        return conv_out if return_feature_maps else [x]


def resnet18(dilate_scale: int = 0, dtype=torch.float32) -> MITResNet:
    return MITResNet("basic", (2, 2, 2, 2), 1, dilate_scale, dtype)


def resnet50(dilate_scale: int = 0, dtype=torch.float32) -> MITResNet:
    return MITResNet("bottleneck", (3, 4, 6, 3), 1, dilate_scale, dtype)


def resnet101(dilate_scale: int = 0, dtype=torch.float32) -> MITResNet:
    return MITResNet("bottleneck", (3, 4, 23, 3), 1, dilate_scale, dtype)


def resnext101(dilate_scale: int = 0, dtype=torch.float32) -> MITResNet:
    return MITResNet("group", (3, 4, 23, 3), 32, dilate_scale, dtype)


# MobileNetV2: (t expand, c out, n repeats, s stride) per group, and the
# features after which the wrapper taps the pyramid
_MBV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
                 (6, 160, 3, 2), (6, 320, 1, 1))
_MBV2_DOWN_IDX = (2, 4, 7, 14)


class ReLU6(nn.Module):
    """``layers.relu6`` as a module (a child of the state dict's
    ``nn.Sequential``, without parameters)."""

    def forward(self, x):
        return relu6(x)


class _InvertedResidual(nn.Module):
    """``conv``: [1x1 expand, BN, ReLU6,] 3x3 depthwise (dilated), BN,
    ReLU6, 1x1 project, BN; the residual where stride 1 keeps the width."""

    def __init__(self, inp: int, oup: int, stride: int, expand: int, dilation: int,
                 dtype=torch.float32):
        super().__init__()
        hidden = round(inp * expand)
        layers = []
        if expand != 1:
            layers += [conv2d(inp, hidden, 1, 1, 0, use_bias=False, dtype=dtype),
                       batch_norm(hidden, dtype), ReLU6()]
        layers += [_conv3x3(hidden, hidden, stride, dilation, dtype, groups=hidden),
                   batch_norm(hidden, dtype), ReLU6(),
                   conv2d(hidden, oup, 1, 1, 0, use_bias=False, dtype=dtype),
                   batch_norm(oup, dtype)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and inp == oup

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.residual else out


class MobileNetV2Dilated(nn.Module):
    """The MobileNetV2 trunk without its classifier and last 1x1 conv, with
    the wrapper's dilation surgery (``dilate_scale`` 0, 8 or 16)."""

    def __init__(self, dilate_scale: int = 8, width_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        c0 = int(32 * width_mult)
        features = [nn.Sequential(conv2d(3, c0, 3, 2, 1, use_bias=False, dtype=dtype),
                                  batch_norm(c0, dtype), ReLU6())]
        plan, inp = [], c0
        for t, c, n, s in _MBV2_SETTING:
            oup = int(c * width_mult)
            for i in range(n):
                plan.append((inp, oup, s if i == 0 else 1, t))
                inp = oup
        down_second, down_last = _MBV2_DOWN_IDX[-2], _MBV2_DOWN_IDX[-1]
        for fi, (inp_c, oup_c, s, t) in enumerate(plan, start=1):
            dil, stride = 1, s
            if dilate_scale == 8:
                if down_second <= fi < down_last:
                    dil, stride = (1 if s == 2 else 2), 1 if s == 2 else s
                elif fi >= down_last:
                    dil, stride = (2 if s == 2 else 4), 1 if s == 2 else s
            elif dilate_scale == 16 and fi >= down_last:
                dil, stride = (1 if s == 2 else 2), 1 if s == 2 else s
            features.append(_InvertedResidual(inp_c, oup_c, stride, t, dil, dtype))
        self.features = nn.Sequential(*features)

    def forward(self, x, return_feature_maps: bool = True):
        conv_out = []
        for fi, layer in enumerate(self.features):
            x = layer(x)
            if fi in _MBV2_DOWN_IDX:
                conv_out.append(x)
        conv_out.append(x)
        return conv_out if return_feature_maps else [x]


BACKBONES = ("resnet18", "resnet18dilated", "resnet50", "resnet50dilated", "resnet101",
             "resnet101dilated", "resnext101", "mobilenetv2dilated")


def build_backbone(arch: str, dilate_scale: int = 8, dtype=torch.float32) -> nn.Module:
    """The registry of the JAX package's ``build_backbone``: a '...dilated'
    name takes ``dilate_scale`` (0 means 8), the others are undilated."""
    if arch not in BACKBONES:
        raise ValueError(f"Unknown backbone: {arch}")
    if arch == "mobilenetv2dilated":
        return MobileNetV2Dilated(dilate_scale or 8, 1.0, dtype)
    make = {"resnet18": resnet18, "resnet50": resnet50, "resnet101": resnet101,
            "resnext101": resnext101}[arch.removesuffix("dilated")]
    return make((dilate_scale or 8) if arch.endswith("dilated") else 0, dtype)
