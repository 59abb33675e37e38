"""The MIT-scene-parsing decoders C1DeepSup, PPM, PPMDeepsup and UPerNet
(counterpart of ``fovealseg_tpu/models/legacy_decoders.py``). NCHW.

As in the JAX package, the builder's ``build_decoder`` does not reach them
(it takes ``c1`` only, as the reference's does); ``build_legacy_decoder`` is
their registry, and ``SegmentationModule(decoder_module=...)`` takes them.
Each takes the backbone's feature pyramid (a list of NCHW maps) and returns
f32 log-softmax class maps, a ``(pred, pred_deepsup)`` pair for the
deep-supervision decoders (``segmentation_module.deep_sup_loss`` combines
the pair), or with ``use_softmax`` the softmax after a bilinear resize to
``seg_hw``. Adaptive average pooling is ``resize_area``, as in the JAX
package. Module names follow the torch state dict. The widths that the JAX
modules infer from their inputs are the reference's: a deep-supervision
branch reads ``fc_dim // 2`` channels, UPerNet's lateral convs
``fpn_inplanes``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fovealseg_torch.core.interpolate import resize_area_nchw, resize_bilinear_nchw
from fovealseg_torch.models.layers import Dropout, batch_norm, conv2d


def _log_softmax(x):
    return torch.log_softmax(x.float(), dim=1)


def _softmax_resized(x, seg_hw):
    if seg_hw is not None:
        x = resize_bilinear_nchw(x, tuple(seg_hw))
    return torch.softmax(x.float(), dim=1)


def _cbr(cin: int, cout: int, dtype, k: int = 3) -> nn.Sequential:
    """conv (k x k, no bias) - BN - ReLU, children ``0`` and ``1``."""
    return nn.Sequential(conv2d(cin, cout, k, 1, k // 2, use_bias=False, dtype=dtype),
                         batch_norm(cout, dtype), nn.ReLU())


class C1DeepSup(nn.Module):
    def __init__(self, num_class: int = 150, fc_dim: int = 2048, use_softmax: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.use_softmax = use_softmax
        self.cbr = _cbr(fc_dim, fc_dim // 4, dtype)
        self.cbr_deepsup = _cbr(fc_dim // 2, fc_dim // 4, dtype)
        self.conv_last = conv2d(fc_dim // 4, num_class, 1, 1, 0, dtype=dtype)
        self.conv_last_deepsup = conv2d(fc_dim // 4, num_class, 1, 1, 0, dtype=dtype)

    def forward(self, conv_out, seg_hw=None):
        x = self.conv_last(self.cbr(conv_out[-1]))
        if self.use_softmax:
            return _softmax_resized(x, seg_hw)
        d = self.conv_last_deepsup(self.cbr_deepsup(conv_out[-2]))
        return _log_softmax(x), _log_softmax(d)


class _AreaPool(nn.Module):
    """Adaptive average pooling to scale x scale (no parameters)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return resize_area_nchw(x, (self.scale, self.scale))


class _PPMPool(nn.Sequential):
    """One pyramid branch: pool (``0``), 1x1 conv (``1``), BN (``2``), ReLU,
    resized back to the input's resolution."""

    def __init__(self, scale: int, fc_dim: int, dtype):
        super().__init__(_AreaPool(scale),
                         conv2d(fc_dim, 512, 1, 1, 0, use_bias=False, dtype=dtype),
                         batch_norm(512, dtype), nn.ReLU())

    def forward(self, x):
        return resize_bilinear_nchw(super().forward(x), tuple(x.shape[-2:]))


def _ppm_head(cin: int, num_class: int, dtype) -> nn.Sequential:
    """conv3x3 - BN - ReLU - Dropout(0.1) - 1x1 classifier (``conv_last``)."""
    return nn.Sequential(conv2d(cin, 512, 3, 1, 1, use_bias=False, dtype=dtype),
                         batch_norm(512, dtype), nn.ReLU(), Dropout(0.1),
                         conv2d(512, num_class, 1, 1, 0, dtype=dtype))


class PPM(nn.Module):
    def __init__(self, num_class: int = 150, fc_dim: int = 4096, use_softmax: bool = False,
                 pool_scales=(1, 2, 3, 6), dtype=torch.float32):
        super().__init__()
        self.use_softmax = use_softmax
        self.ppm = nn.ModuleList(_PPMPool(s, fc_dim, dtype) for s in pool_scales)
        self.conv_last = _ppm_head(fc_dim + len(pool_scales) * 512, num_class, dtype)

    def _pyramid(self, conv5):
        return self.conv_last(torch.cat([conv5] + [p(conv5) for p in self.ppm], dim=1))

    def forward(self, conv_out, seg_hw=None):
        x = self._pyramid(conv_out[-1])
        return _softmax_resized(x, seg_hw) if self.use_softmax else _log_softmax(x)


class PPMDeepsup(PPM):
    def __init__(self, num_class: int = 150, fc_dim: int = 4096, use_softmax: bool = False,
                 pool_scales=(1, 2, 3, 6), dtype=torch.float32):
        super().__init__(num_class, fc_dim, use_softmax, pool_scales, dtype)
        self.cbr_deepsup = _cbr(fc_dim // 2, fc_dim // 4, dtype)
        self.dropout_deepsup = Dropout(0.1)
        self.conv_last_deepsup = conv2d(fc_dim // 4, num_class, 1, 1, 0, dtype=dtype)

    def forward(self, conv_out, seg_hw=None):
        x = self._pyramid(conv_out[-1])
        if self.use_softmax:
            return _softmax_resized(x, seg_hw)
        d = self.conv_last_deepsup(self.dropout_deepsup(self.cbr_deepsup(conv_out[-2])))
        return _log_softmax(x), _log_softmax(d)


class UPerNet(nn.Module):
    """PPM over the top level (its conv after the resize back, unlike PPM's)
    and FPN fusion of the four levels."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096, use_softmax: bool = False,
                 pool_scales=(1, 2, 3, 6), fpn_inplanes=(256, 512, 1024, 2048),
                 fpn_dim: int = 256, dtype=torch.float32):
        super().__init__()
        self.use_softmax = use_softmax
        self.pool_scales = tuple(pool_scales)
        self.ppm_conv = nn.ModuleList(_cbr(fc_dim, 512, dtype, k=1) for _ in pool_scales)
        self.ppm_last_conv = _cbr(fc_dim + len(pool_scales) * 512, fpn_dim, dtype)
        self.fpn_in = nn.ModuleList(_cbr(c, fpn_dim, dtype, k=1) for c in fpn_inplanes[:-1])
        self.fpn_out = nn.ModuleList(nn.Sequential(_cbr(fpn_dim, fpn_dim, dtype))
                                     for _ in fpn_inplanes[:-1])
        self.conv_last = nn.Sequential(_cbr(len(fpn_inplanes) * fpn_dim, fpn_dim, dtype),
                                       conv2d(fpn_dim, num_class, 1, 1, 0, dtype=dtype))

    def forward(self, conv_out, seg_hw=None):
        conv5 = conv_out[-1]
        hw = tuple(conv5.shape[-2:])
        outs = [conv5] + [conv(resize_bilinear_nchw(resize_area_nchw(conv5, (s, s)), hw))
                          for s, conv in zip(self.pool_scales, self.ppm_conv)]
        f = self.ppm_last_conv(torch.cat(outs, dim=1))
        fpn_features = [f]
        for i in reversed(range(len(conv_out) - 1)):
            lat = self.fpn_in[i](conv_out[i])
            f = lat + resize_bilinear_nchw(f, tuple(lat.shape[-2:]))
            fpn_features.append(self.fpn_out[i](f))
        fpn_features.reverse()  # [P2 .. P5]
        out_hw = tuple(fpn_features[0].shape[-2:])
        fusion = [fpn_features[0]] + [resize_bilinear_nchw(t, out_hw) for t in fpn_features[1:]]
        x = self.conv_last(torch.cat(fusion, dim=1))
        return _softmax_resized(x, seg_hw) if self.use_softmax else _log_softmax(x)


LEGACY_DECODERS = {"c1_deepsup": C1DeepSup, "ppm": PPM, "ppm_deepsup": PPMDeepsup,
                   "upernet": UPerNet}


def build_legacy_decoder(arch: str, num_class: int = 150, fc_dim: int = 2048,
                         use_softmax: bool = False, dtype=torch.float32) -> nn.Module:
    """The registry of the decoders that the reference defines and its own
    builder cannot reach."""
    if arch not in LEGACY_DECODERS:
        raise ValueError(f"Unknown legacy decoder: {arch}")
    return LEGACY_DECODERS[arch](num_class=num_class, fc_dim=fc_dim, use_softmax=use_softmax,
                                 dtype=dtype)
