"""The stock semantic-segmentation HRNet, ``seg_hrnet`` (counterpart of
``fovealseg_tpu/models/seg_hrnet.py``). NCHW.

Unlike the flagship's HRNetV2-nodownsp (``models/hrnet.py``): a stem of two
stride-2 3x3 convs (1/4 resolution), stages 2-4 built from the upstream
HRNet config grammar (``extra['STAGE{2,3,4}']``: NUM_MODULES, NUM_BRANCHES,
NUM_BLOCKS per branch, NUM_CHANNELS, BLOCK 'BASIC' or 'BOTTLENECK'), no
dropout in the BasicBlocks, and a ``last_layer`` head (1x1 conv, BN, ReLU,
then a FINAL_CONV_KERNEL x FINAL_CONV_KERNEL conv to the classes) on the
concatenation of every branch upsampled to the top resolution. The
reference's ``InPlaceABNSync(activation='none')`` is plain BN, as in the
JAX package. Module names follow the torch state dict.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn as nn

from fovealseg_torch.core.interpolate import resize_bilinear_nchw
from fovealseg_torch.models.hrnet import BasicBlock, Bottleneck, HighResolutionModule
from fovealseg_torch.models.layers import batch_norm, conv2d

# The published HRNet-W48 semantic-segmentation configuration
# (HRNet-Semantic-Segmentation's seg_hrnet_w48 experiments)
W48_EXTRA = dict(
    STAGE2=dict(NUM_MODULES=1, NUM_BRANCHES=2, NUM_BLOCKS=(4, 4),
                NUM_CHANNELS=(48, 96), BLOCK="BASIC", FUSE_METHOD="SUM"),
    STAGE3=dict(NUM_MODULES=4, NUM_BRANCHES=3, NUM_BLOCKS=(4, 4, 4),
                NUM_CHANNELS=(48, 96, 192), BLOCK="BASIC", FUSE_METHOD="SUM"),
    STAGE4=dict(NUM_MODULES=3, NUM_BRANCHES=4, NUM_BLOCKS=(4, 4, 4, 4),
                NUM_CHANNELS=(48, 96, 192, 384), BLOCK="BASIC", FUSE_METHOD="SUM"),
    FINAL_CONV_KERNEL=1,
)

_EXPANSION = {"BASIC": 1, "BOTTLENECK": 4}


def _branch_block(block: str, channels: int, dtype) -> nn.Module:
    """A branch block of ``channels`` (after expansion), no downsample."""
    if block == "BASIC":
        return BasicBlock(channels, channels, dtype, drop_rate=0.0)
    if block == "BOTTLENECK":
        return Bottleneck(channels, channels // 4, False, dtype)
    raise ValueError(f"Unknown HRNet block type: {block}")


class GeneralHRModule(HighResolutionModule):
    """One config-driven exchange unit: ``num_blocks[i]`` blocks of ``block``
    on branch i (``channels`` after expansion), then the all-to-all fuse."""

    def __init__(self, channels, num_blocks, block: str = "BASIC", dtype=torch.float32):
        super().__init__(channels, num_blocks, dtype,
                         make_block=lambda c: _branch_block(block, c, dtype))


def _conv_bn_relu(cin: int, cout: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, 3, stride, 1, use_bias=False, dtype=dtype),
                         batch_norm(cout, dtype), nn.ReLU())


class SegHRNet(nn.Module):
    """``HighResolutionNet``: stem, layer1 (4 Bottlenecks 64 -> 256), the
    config's stages 2-4, and the ``last_layer`` head; class logits at 1/4 of
    the input's resolution. ``extra`` defaults to :data:`W48_EXTRA`."""

    def __init__(self, num_classes: int, extra: Mapping | None = None, dtype=torch.float32):
        super().__init__()
        extra = W48_EXTRA if extra is None else extra
        self.conv1 = conv2d(3, 64, 3, 2, 1, use_bias=False, dtype=dtype)
        self.bn1 = batch_norm(64, dtype)
        self.conv2 = conv2d(64, 64, 3, 2, 1, use_bias=False, dtype=dtype)
        self.bn2 = batch_norm(64, dtype)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if b == 0 else 256, 64, b == 0, dtype)
                                      for b in range(4)])
        pre = [256]
        for sidx, key in ((1, "STAGE2"), (2, "STAGE3"), (3, "STAGE4")):
            scfg = extra[key]
            block = scfg.get("BLOCK", "BASIC")
            cur = [c * _EXPANSION[block] for c in scfg["NUM_CHANNELS"]]
            trans = nn.ModuleList()
            for i in range(scfg["NUM_BRANCHES"]):
                if i < len(pre):
                    trans.append(_conv_bn_relu(pre[i], cur[i], 1, dtype) if cur[i] != pre[i]
                                 else None)
                else:  # a new branch: stride-2 convs down from the coarsest
                    steps = i + 1 - len(pre)
                    trans.append(nn.Sequential(*[
                        _conv_bn_relu(pre[-1], cur[i] if j == steps - 1 else pre[-1], 2, dtype)
                        for j in range(steps)]))
            setattr(self, f"transition{sidx}", trans)
            setattr(self, f"stage{sidx + 1}", nn.Sequential(*[
                GeneralHRModule(cur, scfg["NUM_BLOCKS"], block, dtype)
                for _ in range(scfg["NUM_MODULES"])]))
            pre = cur
        c_all = sum(pre)
        k = int(extra.get("FINAL_CONV_KERNEL", 1))
        self.last_layer = nn.Sequential(
            conv2d(c_all, c_all, 1, 1, 0, use_bias=True, dtype=dtype), batch_norm(c_all, dtype),
            nn.ReLU(), conv2d(c_all, num_classes, k, 1, 1 if k == 3 else 0, use_bias=True,
                              dtype=dtype))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        feats = [self.layer1(x)]
        for sidx in (1, 2, 3):
            trans = getattr(self, f"transition{sidx}")
            feats = [feats[i] if t is None else t(feats[min(i, len(feats) - 1)])
                     for i, t in enumerate(trans)]
            feats = getattr(self, f"stage{sidx + 1}")(feats)
        h, w = feats[0].shape[-2:]
        cat = torch.cat([feats[0]] + [resize_bilinear_nchw(f, (h, w)) for f in feats[1:]], dim=1)
        return self.last_layer(cat)


def get_seg_model(num_classes: int, extra: Mapping | None = None,
                  dtype=torch.float32) -> SegHRNet:
    """The upstream factory: config -> model."""
    return SegHRNet(num_classes, extra, dtype)
