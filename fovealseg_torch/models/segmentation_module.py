"""Plain (non-foveated) segmentation module (counterpart of
``fovealseg_tpu/models/segmentation_module.py``).

Encoder -> decoder, used by the multi-scale ODGT evaluation with
``--no-deform`` and for non-foveated baselines. The forward returns the
decoder's logits (a ``(pred, pred_deepsup)`` pair for a deep-supervision
decoder); ``deep_sup_loss`` combines the two criterion terms with
``deep_sup_scale`` as the reference does. ``infer`` gives class
probabilities in f32, resized bilinearly to ``seg_hw``. The state-dict keys
are ``encoder.*`` and ``decoder.*``, the JAX package's export layout.
"""

from __future__ import annotations

import torch
from torch import nn

from fovealseg_torch import resolve_device
from fovealseg_torch.core.interpolate import resize_bilinear


def deep_sup_loss(crit, preds, label, deep_sup_scale: float):
    """loss = crit(pred) + deep_sup_scale * crit(pred_deepsup)."""
    pred, pred_deepsup = preds
    return crit(pred, label) + deep_sup_scale * crit(pred_deepsup, label)


class SegmentationModule(nn.Module):
    """``config``: a ``DeformConfig`` (``arch_encoder``, ``arch_decoder``,
    ``fc_dim`` and ``num_class`` are read). ``decoder_module`` replaces the
    builder's decoder (the reference passes its decoder in directly).
    ``device`` defaults to ``cuda`` and raises when no card is present."""

    def __init__(self, config, dtype: torch.dtype = torch.float32, device=None,
                 decoder_module: nn.Module | None = None):
        super().__init__()
        from fovealseg_torch.models.builder import build_decoder, build_encoder

        self.device = resolve_device(device)
        self.config = c = config
        self.dtype = dtype
        self.encoder = build_encoder(c.arch_encoder, c.fc_dim, dtype)
        self.decoder = decoder_module if decoder_module is not None else build_decoder(
            c.arch_decoder, c.fc_dim, c.num_class, dtype)
        self.to(self.device)
        self.eval()

    def forward(self, x: torch.Tensor):
        """x [B, H, W, 3] -> logits [B, h, w, C] (or a deep-supervision pair),
        in the module's current train or eval mode."""
        out = self.decoder(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2).contiguous()))
        if isinstance(out, tuple):
            return tuple(o.permute(0, 2, 3, 1) for o in out)
        return out.permute(0, 2, 3, 1)

    @torch.no_grad()
    def infer(self, x: torch.Tensor, seg_hw: tuple[int, int] | None = None) -> torch.Tensor:
        """Softmax probabilities [B, Hs, Ws, C] in f32 (eval mode), resized
        bilinearly to ``seg_hw`` when it differs from the logits' size."""
        was_training = self.training
        self.eval()
        try:
            logits = self(x)
        finally:
            self.train(was_training)
        if isinstance(logits, tuple):
            logits = logits[0]
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        if seg_hw is not None and tuple(seg_hw) != tuple(probs.shape[1:3]):
            probs = resize_bilinear(probs, tuple(seg_hw))
        return probs
