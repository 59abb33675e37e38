"""HRNetV2 "nodownsp" encoder (counterpart of ``fovealseg_tpu/models/hrnet.py``).

Stride-1 stem, 4 Bottlenecks 64 -> 256, stages 2/3/4 with 2/3/4 branches of
(64, 128, 256, 512) channels and (1, 4, 3) modules of 4 BasicBlocks, the
all-to-all HRNet fuse, and a head that upsamples every branch to the top
resolution and concatenates them (960 channels). NCHW. The up-resizes go
through ``layers.trunk_resize``, which row-partitioned serving
(``parallel/spatial.py``) routes to its row blocks.

The module tree mirrors the reference's torch module paths
(``nn.Sequential``/``nn.ModuleList``, ``None`` where the reference has no
module), so keys such as ``stage3.2.fuse_layers.1.0.0.0.weight`` come out of
``state_dict()`` as the JAX package exports them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import Dropout, batch_norm, conv2d, trunk_resize

STAGE_CHANNELS = ((64, 128), (64, 128, 256), (64, 128, 256, 512))


class BasicBlock(nn.Module):
    """conv-dropout-BN-ReLU, conv-dropout-BN, residual ReLU (dropout 0.3,
    inert in eval)."""

    def __init__(self, inplanes: int, planes: int, dtype=torch.float32, drop_rate: float = 0.3):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.dropout = Dropout(drop_rate)
        self.bn1 = batch_norm(planes, dtype)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.dropout2 = Dropout(drop_rate)
        self.bn2 = batch_norm(planes, dtype)

    def forward(self, x):
        out = torch.relu(self.bn1(self.dropout(self.conv1(x))))
        out = self.bn2(self.dropout2(self.conv2(out)))
        return torch.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, has_downsample: bool, dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv2d(inplanes, planes, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(planes, dtype)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = batch_norm(planes, dtype)
        self.conv3 = conv2d(planes, out, 1, 1, 0, use_bias=False, dtype=dtype)
        self.bn3 = batch_norm(out, dtype)
        self.downsample = (nn.Sequential(conv2d(inplanes, out, 1, 1, 0, use_bias=False, dtype=dtype),
                                         batch_norm(out, dtype))
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


def _conv_bn_relu(cin: int, cout: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, 3, stride, 1, use_bias=False, dtype=dtype),
                         batch_norm(cout, dtype), nn.ReLU())


class HighResolutionModule(nn.Module):
    """One HRNet exchange unit: per-branch BasicBlocks + all-to-all fuse.
    ``num_blocks``: blocks per branch, one count or one per branch;
    ``make_block(channels)`` builds a branch block (default: a BasicBlock
    with dropout 0.3)."""

    def __init__(self, channels, num_blocks=4, dtype=torch.float32, make_block=None):
        super().__init__()
        n = len(channels)
        counts = tuple(num_blocks) if isinstance(num_blocks, (tuple, list)) else (num_blocks,) * n
        make_block = make_block or (lambda c: BasicBlock(c, c, dtype))
        self.branches = nn.ModuleList(
            nn.Sequential(*[make_block(channels[i]) for _ in range(counts[i])]) for i in range(n))
        fuse = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:  # coarse -> fine: 1x1 conv + BN, then bilinear up
                    row.append(nn.Sequential(
                        conv2d(channels[j], channels[i], 1, 1, 0, use_bias=False, dtype=dtype),
                        batch_norm(channels[i], dtype)))
                else:  # fine -> coarse: chain of stride-2 3x3 convs
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out_ch = channels[i] if last else channels[j]
                        step = [conv2d(channels[j], out_ch, 3, 2, 1, use_bias=False, dtype=dtype),
                                batch_norm(out_ch, dtype)]
                        if not last:
                            step.append(nn.ReLU())
                        steps.append(nn.Sequential(*step))
                    row.append(nn.Sequential(*steps))
            fuse.append(row)
        self.fuse_layers = fuse

    def forward(self, xs):
        feats = [branch(x) for branch, x in zip(self.branches, xs)]
        if len(feats) == 1:
            return feats
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = feats[j]
                elif j > i:
                    t = trunk_resize(layer(feats[j]), feats[i].shape[-2:])
                else:
                    t = layer(feats[j])
                y = t if y is None else y + t
            fused.append(torch.relu(y))
        return fused


class HRNetV2NoDownsp(nn.Module):
    """Full encoder; returns [features] with 960 channels at input resolution.

    ``stage_modules``/``num_blocks``/``layer1_blocks`` default to the
    reference architecture; the tiny variant reduces them."""

    def __init__(self, dtype=torch.float32, stage_modules=(1, 4, 3), num_blocks: int = 4,
                 layer1_blocks: int = 4):
        super().__init__()
        self.conv1 = conv2d(3, 64, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(64, dtype)
        self.conv2 = conv2d(64, 64, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = batch_norm(64, dtype)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if b == 0 else 256, 64, b == 0, dtype)
                                      for b in range(layer1_blocks)])
        self.transition1 = nn.ModuleList([
            _conv_bn_relu(256, 64, 1, dtype),
            nn.Sequential(_conv_bn_relu(256, 128, 2, dtype)),
        ])
        self.stage2 = nn.Sequential(*[HighResolutionModule(STAGE_CHANNELS[0], num_blocks, dtype)
                                      for _ in range(stage_modules[0])])
        self.transition2 = nn.ModuleList([None, None, nn.Sequential(_conv_bn_relu(128, 256, 2, dtype))])
        self.stage3 = nn.Sequential(*[HighResolutionModule(STAGE_CHANNELS[1], num_blocks, dtype)
                                      for _ in range(stage_modules[1])])
        self.transition3 = nn.ModuleList([None, None, None,
                                          nn.Sequential(_conv_bn_relu(256, 512, 2, dtype))])
        self.stage4 = nn.Sequential(*[HighResolutionModule(STAGE_CHANNELS[2], num_blocks, dtype)
                                      for _ in range(stage_modules[2])])

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        feats = self.stage2([self.transition1[0](x), self.transition1[1](x)])
        feats = self.stage3(feats + [self.transition2[2](feats[-1])])
        feats = self.stage4(feats + [self.transition3[3](feats[-1])])
        h, w = feats[0].shape[-2:]
        ups = [feats[0]] + [trunk_resize(f, (h, w)) for f in feats[1:]]
        return [torch.cat(ups, dim=1)]
