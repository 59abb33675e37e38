"""Saliency ("foveater") network and the compress head (counterpart of
``fovealseg_tpu/models/saliency.py``; ``fovsimple`` only). NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import batch_norm, conv2d, relu6


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
