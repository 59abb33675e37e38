"""C1 decoder (mask + class) with its classification ResNet head (counterpart
of ``fovealseg_tpu/models/c1.py``). NCHW.

``cbr`` (3x3 conv-BN-ReLU, fc_dim -> fc_dim/4) and a 1x1 conv give one mask
logit; the mask is ``sigmoid(x) - 0.5`` in f32. ``cls_net`` (two
ResidualBlocks, strides 4 and 2, global mean pool, FC) gives the class
logits, broadcast over H x W with the last (background) channel multiplied
by the mask. The output is f32, as the JAX concatenation promotes it. The
global mean goes through ``layers.trunk_mean`` (row-partitioned serving
all-reduces it).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import batch_norm, conv2d, linear, trunk_mean


class ResidualBlock(nn.Module):
    """Convs with torch-default bias=True."""

    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Sequential(conv2d(inplanes, planes, 3, stride, 1, dtype=dtype),
                                   batch_norm(planes, dtype))
        self.conv2 = nn.Sequential(conv2d(planes, planes, 3, 1, 1, dtype=dtype),
                                   batch_norm(planes, dtype))
        self.downsample = (nn.Sequential(conv2d(inplanes, planes, 1, stride, 0, dtype=dtype),
                                         batch_norm(planes, dtype))
                           if has_downsample else None)

    def forward(self, x):
        out = self.conv2(torch.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ClsResNet(nn.Module):
    """fc_dim -> 512 (stride 4) -> 512 (stride 2) -> global mean -> FC."""

    def __init__(self, fc_dim: int = 960, num_class: int = 51, dtype=torch.float32):
        super().__init__()
        self.layer2 = nn.Sequential(ResidualBlock(fc_dim, 512, 4, True, dtype))
        self.layer3 = nn.Sequential(ResidualBlock(512, 512, 2, True, dtype))
        self.fc = linear(512, num_class, dtype)

    def forward(self, x):
        x = self.layer3(self.layer2(x))
        return self.fc(trunk_mean(x))


class C1(nn.Module):
    """Mask + class decoder; [features] -> [B, num_class, H, W] f32 logits."""

    def __init__(self, num_class: int = 51, fc_dim: int = 960, dtype=torch.float32):
        super().__init__()
        self.num_class = num_class
        self.cbr = nn.Sequential(conv2d(fc_dim, fc_dim // 4, 3, 1, 1, use_bias=False, dtype=dtype),
                                 batch_norm(fc_dim // 4, dtype), nn.ReLU())
        self.conv_last = conv2d(fc_dim // 4, 1, 1, 1, 0, dtype=dtype)
        self.cls_net = ClsResNet(fc_dim, num_class, dtype)

    def forward(self, conv_out):
        conv5 = conv_out[-1] if isinstance(conv_out, (list, tuple)) else conv_out
        mask = torch.sigmoid(self.conv_last(self.cbr(conv5)).float()) - 0.5  # [B, 1, H, W]
        cls = self.cls_net(conv5).float()  # [B, C]
        b, _, h, w = mask.shape
        cls_map = cls[:, :, None, None].expand(b, self.num_class, h, w)
        return torch.cat([cls_map[:, :-1], cls_map[:, -1:] * mask], dim=1)
