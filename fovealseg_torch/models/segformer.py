"""SegFormer (MiT-B5) encoder (counterpart of ``fovealseg_tpu/models/segformer.py``).

The HF ``SegformerConfig`` of the reference with depths (3, 6, 40, 3), hidden
sizes (64, 128, 320, 512), strides (1, 2, 2, 2) (stage 1 at full
resolution), heads (1, 2, 5, 8), spatial-reduction ratios (8, 4, 2, 1) and
MixFFN ratio 4. The output is the channel concatenation of the four stage
maps, the coarser three resized in f32 to stage 1's size and cast back:
64 + 128 + 320 + 512 = 1024 channels (``MODEL.fc_dim 1024``).

Maps run NCHW; the blocks work on token lists ``[B, N, C]`` in row-major
(H, W) order, the JAX package's order. The attention keeps the JAX
arithmetic: ``q @ k^T``, then the division by ``sqrt(head_dim)``, the softmax
in f32, the cast to the compute dtype, then ``@ v``, as plain matrix
products. The module tree follows the HF state dict under
``segformer.encoder.*``, nested, so that ``state_dict()`` keys equal the JAX
package's dotted export (``segformer.encoder.block.2.39.attention.self.sr``).
In train mode the attention probabilities (0.2), the hidden states (0.3)
and the residual branches (drop path, 0.1 spread linearly over the blocks)
draw from the dropout generator.

Row-partitioned serving (``parallel/spatial.py``) runs this forward on each
rank's rows of the map: the convs (patch embeddings, reduction convs,
MixFFN's depthwise conv) fetch their halos as ``spatial.RowConv2d``, the
stage maps resize through ``layers.trunk_resize``, and LayerNorm, the
``Linear`` layers, GELU and the residual adds are per token. The attention
keeps its queries on the local tokens; its keys and values come from the
whole map, gathered by ``layers.trunk_gather`` before the per-token work
(the reduction conv's output in stages 1-3, the tokens themselves in stage
4), and every rank then runs the LayerNorm and the key and value
projections on the whole reduced sequence. Gathering after them would move
the keys and the values, twice the bytes of their input, through the
exchange (through the host with gloo), to save per-token work on a
sequence that the reduction makes short (100 tokens in every stage at the
flagship's 80x80 task).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from fovealseg_torch.models.layers import (
    DropPath,
    Dropout,
    LayerNorm,
    at_least_f32,
    conv2d,
    gelu,
    linear,
    trunk_gather,
    trunk_resize,
)

B5 = dict(
    depths=(3, 6, 40, 3),
    hidden_sizes=(64, 128, 320, 512),
    strides=(1, 2, 2, 2),
    patch_sizes=(7, 3, 3, 3),
    num_heads=(1, 2, 5, 8),
    sr_ratios=(8, 4, 2, 1),
    mlp_ratio=4,
)


def _dense(cin: int, cout: int, dtype) -> nn.Module:
    return linear(cin, cout, dtype, init="xavier_uniform")


def _to_map(tokens: torch.Tensor, hw) -> torch.Tensor:
    """[B, H*W, C] row-major tokens -> [B, C, H, W]."""
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, hw[0], hw[1])


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] row-major tokens."""
    return x.flatten(2).transpose(1, 2)


class EfficientSelfAttention(nn.Module):
    """HF ``SegformerEfficientSelfAttention`` and its output projection
    (``attention.self.*``, ``attention.output.dense``)."""

    def __init__(self, hidden: int, heads: int, sr_ratio: int, dtype=torch.float32):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        sa = nn.Module()
        sa.query = _dense(hidden, hidden, dtype)
        sa.key = _dense(hidden, hidden, dtype)
        sa.value = _dense(hidden, hidden, dtype)
        if sr_ratio > 1:
            sa.sr = conv2d(hidden, hidden, sr_ratio, sr_ratio, 0, dtype=dtype)
            sa.layer_norm = LayerNorm(hidden, dtype=dtype)
        self.add_module("self", sa)
        self.output = nn.Module()
        self.output.dense = _dense(hidden, hidden, dtype)
        self.attn_drop = Dropout(0.2)  # the reference's attention_probs_dropout_prob
        self.proj_drop = Dropout(0.3)  # its hidden_dropout_prob

    def forward(self, x, hw):
        sa = getattr(self, "self")
        b, n, c = x.shape
        hd = c // self.heads
        q = sa.query(x)
        if self.sr_ratio > 1:
            kv = sa.layer_norm(_to_tokens(trunk_gather(sa.sr(_to_map(x, hw)))))
        else:
            kv = trunk_gather(x, hw)
        k, v = sa.key(kv), sa.value(kv)

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(at_least_f32(attn), dim=-1).to(q.dtype)
        out = torch.matmul(self.attn_drop(attn), v)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.output.dense(out))


class MixFFN(nn.Module):
    """dense -> 3x3 depthwise conv -> GELU (tanh) -> dense (HF ``SegformerMixFFN``)."""

    def __init__(self, hidden: int, ratio: int = 4, dtype=torch.float32):
        super().__init__()
        mid = hidden * ratio
        self.dense1 = _dense(hidden, mid, dtype)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = conv2d(mid, mid, 3, 1, 1, dtype=dtype, groups=mid)
        self.dense2 = _dense(mid, hidden, dtype)
        self.drop1 = Dropout(0.3)
        self.drop2 = Dropout(0.3)

    def forward(self, x, hw):
        y = self.dense1(x)
        y = _to_tokens(self.dwconv.dwconv(_to_map(y, hw)))
        y = self.drop1(gelu(y))
        return self.drop2(self.dense2(y))


class SegformerLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int, mlp_ratio: int, drop_path: float,
                 dtype=torch.float32):
        super().__init__()
        self.layer_norm_1 = LayerNorm(hidden, dtype=dtype)
        self.attention = EfficientSelfAttention(hidden, heads, sr_ratio, dtype)
        self.layer_norm_2 = LayerNorm(hidden, dtype=dtype)
        self.mlp = MixFFN(hidden, mlp_ratio, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, hw):
        x = x + self.drop_path(self.attention(self.layer_norm_1(x), hw))
        return x + self.drop_path(self.mlp(self.layer_norm_2(x), hw))


class SegFormerEncoder(nn.Module):
    """MiT trunk; returns ``[features]``, [B, sum(hidden), H, W] at the input's
    resolution. ``cfg`` defaults to ``B5``; tests pass a reduced one."""

    def __init__(self, cfg: dict | None = None, drop_path_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        cfg = cfg or B5
        self.cfg, self.dtype = cfg, dtype
        depths = cfg["depths"]
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        enc = nn.Module()
        enc.patch_embeddings = nn.ModuleList()
        enc.block = nn.ModuleList()
        enc.layer_norm = nn.ModuleList()
        cin, cur = 3, 0
        for s in range(4):
            ps, st, ch = cfg["patch_sizes"][s], cfg["strides"][s], cfg["hidden_sizes"][s]
            emb = nn.Module()
            emb.proj = conv2d(cin, ch, ps, st, ps // 2, dtype=dtype)
            emb.layer_norm = LayerNorm(ch, dtype=dtype)
            enc.patch_embeddings.append(emb)
            enc.block.append(nn.ModuleList(
                SegformerLayer(ch, cfg["num_heads"][s], cfg["sr_ratios"][s], cfg["mlp_ratio"],
                               rates[cur + j], dtype)
                for j in range(depths[s])))
            enc.layer_norm.append(LayerNorm(ch, dtype=dtype))
            cur += depths[s]
            cin = ch
        self.segformer = nn.Module()
        self.segformer.encoder = enc

    def forward(self, x):
        enc = self.segformer.encoder
        feats = []
        for emb, blocks, norm in zip(enc.patch_embeddings, enc.block, enc.layer_norm):
            x = emb.proj(x)
            hw = tuple(x.shape[-2:])
            tokens = emb.layer_norm(_to_tokens(x))
            for blk in blocks:
                tokens = blk(tokens, hw)
            x = _to_map(norm(tokens), hw)
            feats.append(x)
        h1, w1 = feats[0].shape[-2:]
        ups = [feats[0]] + [trunk_resize(at_least_f32(f), (h1, w1)).to(self.dtype)
                            for f in feats[1:]]
        return [torch.cat(ups, dim=1)]
