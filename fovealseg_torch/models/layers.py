"""Shared building blocks (counterpart of ``fovealseg_tpu/models/layers.py``).

Modules run NCHW. Parameters stay f32 (so state dicts match the JAX export
one for one); each layer computes in the ``dtype`` it was built with, as the
JAX modules' ``dtype`` does: a conv or linear layer casts its input and its
weights to that type, and BatchNorm normalizes in f32 and returns that type.
Under ``torch.no_grad`` the cast weights are cached until the parameter
changes (not under a trace: an exported program casts them in its graph).

BN follows the JAX package's flax BatchNorm: eps 1e-5; in eval mode it
normalises with the running statistics; in train mode with the batch's
(biased) statistics, and it updates the running ones in place with momentum
0.1 (flax's 0.9) and the **biased** batch variance, as flax does
(``nn.BatchNorm2d`` would fold in the unbiased one). Cross-rank BN (the JAX
package's ``axis_name``, ``TPU.sync_bn``) is a process group set on each
``BatchNorm2d`` by :func:`convert_sync_bn`; it applies in train mode with
more than one rank. ``Dropout`` draws its
mask from an explicit ``torch.Generator``, installed for a forward by
:func:`dropout_generator` (the counterpart of ``rngs={'dropout': rng}``).
Inside :func:`batch_block` (the 2-D mesh's step) ``Dropout`` and ``DropPath``
draw the global batch's mask and keep this rank's block of it, so that the
ranks together draw what one process draws for the global batch.

Init mirrors the JAX package: Kaiming-normal (fan_in) conv and linear
weights (xavier-uniform for a ``Linear`` built with ``init="xavier_uniform"``,
SegFormer's ``Dense``), zero biases, BN scale 1 and bias 1e-4, LayerNorm and
the batch-statistics norm scale 1 and bias 0.

For SegFormer and the ResNetZoom saliency nets: ``LayerNorm`` is flax's
(statistics in f32, the variance as E[x^2] - E[x]^2, the result cast to the
compute dtype), ``gelu`` is flax's tanh approximation, ``DropPath`` keeps or
drops whole samples from the dropout generator, and ``BatchStatsNorm`` is the
JAX package's ``_BatchStatsNorm`` (the ``_nonsyn`` nets' BN: the current
batch's statistics in train and eval, no running statistics).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from fovealseg_torch.core.interpolate import resize_bilinear_nchw
from fovealseg_torch.ops.quant import w8a8_conv2d


class _CastCache:
    """Weights in the layer's compute dtype, cached while gradients are off
    (and never under a trace, which casts the parameter in its program)."""

    def _cast_param(self, name: str, p: torch.Tensor | None):
        if p is None or p.dtype == self.compute_dtype:
            return p
        if torch.is_grad_enabled() or torch.compiler.is_compiling():
            return p.to(self.compute_dtype)
        cache = self.__dict__.setdefault("_cast", {})
        key = (p.data_ptr(), p._version, p.device)
        hit = cache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(self.compute_dtype))
            cache[name] = hit
        return hit[1]


class Conv2d(_CastCache, nn.Conv2d):
    """torch ``nn.Conv2d`` (symmetric padding) computing in ``dtype``.

    ``quantizable`` marks a conv that the JAX package builds as ``TorchConv``
    (the default); its plain ``nn.Conv`` counterparts (dilated trunks,
    SegFormer's patch embeds, depthwise convs) are built with
    ``quantizable=False``, and ``TPU.quantize`` never touches them. A conv
    on which :func:`quantize_model` has stored the buffers ``weight_q`` and
    ``w_scale`` runs W8A8 (``ops/quant.py::w8a8_conv2d``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype = torch.float32,
                 dilation: int = 1, groups: int = 1, quantizable: bool = True):
        super().__init__(cin, cout, kernel_size, stride, padding, dilation, groups, bias=bias)
        self.compute_dtype = dtype
        self.quantizable = quantizable

    def forward(self, x):
        if "weight_q" in self._buffers:
            return w8a8_conv2d(x.to(self.compute_dtype), self.weight_q, self.w_scale,
                               self._cast_param("bias", self.bias), self.stride[0],
                               self.padding[0])
        return self._conv_forward(x.to(self.compute_dtype),
                                  self._cast_param("weight", self.weight),
                                  self._cast_param("bias", self.bias))


# W8A8 serving (TPU.quantize="int8"; fovealseg_tpu/models/layers.py:66-98): symmetric
# int8, zero-point 0; a per-output-channel weight scale, a per-tensor dynamic
# activation scale (the micro-batch's); int32 sums, then z * (s_x * s_w) in f32, then
# the bias. Only on convs with at least QUANT_MIN_CH input and output channels.
QUANT_MIN_CH = 128


def quantize_kernel(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes [cout, cin, kh, kw], f32 scale [cout]) of an f32 conv
    weight [cout, cin, kh, kw]: ``s_w = max(max |W[c]|, 1e-12) / 127`` and
    ``round_half_even(W / s_w)``, the JAX package's ``quantize_kernel``,
    computed on the host (PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal) and returned on the weight's device."""
    w = weight.detach().float().cpu()
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    codes = torch.round(w / s_w.view(-1, 1, 1, 1)).to(torch.int8)
    return codes.to(weight.device), s_w.to(weight.device)


@torch.no_grad()
def quantize_model(model: nn.Module) -> int:
    """Quantize the weight of every conv marked ``quantizable`` (a JAX
    ``TorchConv``) with at least ``QUANT_MIN_CH`` input and output channels,
    once (the counterpart of the JAX package's ``quantize_params`` restricted
    to ``quantized_kernel_paths``): each gets the non-persistent buffers
    ``weight_q`` (int8 codes, [cout, kh, kw, cin], the layout K8 reads) and
    ``w_scale`` (f32 [cout]) on its weight's device, and runs W8A8 from then
    on. Call it after the weights load. Returns the count of convs quantized."""
    count = 0
    for m in model.modules():
        if not (isinstance(m, Conv2d) and m.quantizable and m.in_channels >= QUANT_MIN_CH
                and m.out_channels >= QUANT_MIN_CH):
            continue
        if m.groups != 1 or m.dilation != (1, 1):
            raise ValueError(f"a quantizable conv must be dense and undilated: {m}")
        codes, s_w = quantize_kernel(m.weight)
        m.register_buffer("weight_q", codes.permute(0, 2, 3, 1).contiguous(), persistent=False)
        m.register_buffer("w_scale", s_w, persistent=False)
        count += 1
    return count


class BatchNorm2d(nn.BatchNorm2d):
    """flax-semantics BN (eps 1e-5, torch momentum 0.1 == flax 0.9);
    normalizes in f32 and returns ``dtype``. In train mode the running
    variance takes the biased batch variance, and ``num_batches_tracked``
    stays 0, as the JAX package's exports write it.

    ``process_group`` (set by :func:`convert_sync_bn`): in train mode over
    more than one rank, the statistics of the batch that the ranks hold
    together (flax's under ``axis_name``, and the global batch's of the
    JAX package's GSPMD step), in f32: each rank's per-channel mean and
    biased variance (two passes) and count, combined exactly as parallel
    variances combine, and ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias``; the running statistics take the global mean and biased
    variance. The backward is PyTorch's (cuDNN's and ``SyncBatchNorm``'s)
    arithmetic with the sums of ``dy`` and ``dy * (x - mean)`` taken over
    the ranks (:class:`_SyncedBatchNorm`): the form ``E[x^2] - mean^2``
    differentiates into the difference of two large terms, and at the
    flagship's class branch, whose upstream gradient is constant over each
    map, that difference is most of the result.
    """

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype
        self.process_group = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(self.compute_dtype)
        if self.process_group is not None and dist.get_world_size(self.process_group) > 1:
            return self._synced(x)
        # PyTorch updates a running variance with the unbiased vu = vb * n / (n - 1):
        # upd = (1 - m) * old + m * vu. The biased update (1 - m) * old + m * vb is
        # upd * (1 - 1/n) + (1 - m) * old / n. The op updates a copy (autograd
        # keeps it), and the buffer takes the biased value from it.
        n = x.numel() // x.shape[1]
        m = self.momentum
        upd = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, upd, self.weight, self.bias, True, m, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - m) / n).add_(upd, alpha=1.0 - 1.0 / n)
        return out.to(self.compute_dtype)

    def _synced(self, x):
        y, mean, var = _SyncedBatchNorm.apply(at_least_f32(x), self.weight, self.bias, self.eps,
                                              self.process_group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(self.compute_dtype)


class _SyncedBatchNorm(torch.autograd.Function):
    """Train-mode BN over the ranks of a group, NCHW in f32: returns the
    output and the global mean and biased variance (no gradient).

    Forward: one all-reduce gathers each rank's (mean, biased variance,
    count) into its slot of a [world, 3, C] buffer (the other slots are
    zero, so the sum is exact); the global mean is the count-weighted mean,
    the global variance the count-weighted mean of ``var_r + (mean_r -
    mean)^2``. Backward: ``dx = (dy - sum(dy) / N - (x - mean) * invstd^2 *
    sum(dy * (x - mean)) / N) * invstd * weight`` with both sums over the
    ranks (one all-reduce), so each rank's input gets the gradient of every
    rank's loss through the shared statistics; the weight and bias get this
    rank's sums, which the data-parallel step reduces."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = (0, 2, 3)
        var_r, mean_r = torch.var_mean(x, dim=dims, unbiased=False)
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        slots = x.new_zeros(world, 3, x.shape[1])
        slots[rank, 0], slots[rank, 1] = mean_r, var_r
        slots[rank, 2] = x.numel() // x.shape[1]
        dist.all_reduce(slots, group=group)
        means, variances, counts = slots.unbind(1)
        n = counts.sum(0)
        mean = (means * counts).sum(0) / n
        var = ((variances + (means - mean).square()) * counts).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        y = ((x - mean.view(1, -1, 1, 1)) * (invstd * weight).view(1, -1, 1, 1)
             + bias.view(1, -1, 1, 1))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = (0, 2, 3)
        xmu = x - mean.view(1, -1, 1, 1)
        local = torch.stack([dy.sum(dim=dims), (dy * xmu).sum(dim=dims)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        sum_dy, sum_dy_xmu = (total / n).unbind()
        dx = ((dy - sum_dy.view(1, -1, 1, 1)
               - xmu * (invstd.square() * sum_dy_xmu).view(1, -1, 1, 1))
              * (invstd * weight).view(1, -1, 1, 1))
        return dx, local[1] * invstd, local[0], None, None


def convert_sync_bn(model: nn.Module, group) -> int:
    """Cross-rank BN over ``group`` on every ``BatchNorm2d`` of ``model``
    (None turns it off). The modules stay, so the state-dict keys do;
    ``BatchStatsNorm`` (the ``_nonsyn`` nets) is never synced, as in the
    JAX package. Returns the number of layers set."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
            n += 1
    return n


class _RankSum(torch.autograd.Function):
    """``psum`` over a process group, also in the backward: statistics that
    every rank's loss reads through its own block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def set_batch_stats_group(model: nn.Module, group) -> int:
    """Take the statistics of every ``BatchStatsNorm`` of ``model`` over the
    ranks of ``group`` (None: this rank's batch alone), as the JAX package's
    GSPMD steps take them over the global batch. Returns the number of
    layers set."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchStatsNorm):
            m.process_group = group
            n += 1
    return n


class _DropoutRng:
    generator: torch.Generator | None = None
    block: tuple[int, int] | None = None  # (this rank's index, blocks in the global batch)


@contextlib.contextmanager
def batch_block(index: int, count: int):
    """Inside the block, a train-mode ``Dropout`` or ``DropPath`` given a
    batch of B draws the mask of the global batch of ``count * B`` and keeps
    the ``index``-th block of B (the JAX package's 2-D step draws one mask
    for the global batch from one key)."""
    prev = _DropoutRng.block
    _DropoutRng.block = (index, count)
    try:
        yield
    finally:
        _DropoutRng.block = prev


def _keep_mask(shape, x: torch.Tensor, keep: float, gen: torch.Generator) -> torch.Tensor:
    """A Bernoulli(``keep``) mask of ``shape`` (batch first) in ``x``'s dtype
    and device, drawn from ``gen``; inside :func:`batch_block`, this rank's
    block of the global batch's mask."""
    block = _DropoutRng.block
    if block is None:
        like = torch.empty_like(x) if tuple(shape) == tuple(x.shape) else torch.empty(
            shape, dtype=x.dtype, device=x.device)
        return like.bernoulli_(keep, generator=gen)
    index, count = block
    b = shape[0]
    full = torch.empty((b * count, *shape[1:]), dtype=x.dtype, device=x.device)
    return full.bernoulli_(keep, generator=gen)[index * b:(index + 1) * b]


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator | None):
    """Train-mode ``Dropout`` layers inside the block draw from ``generator``
    (on the activations' device)."""
    prev = _DropoutRng.generator
    _DropoutRng.generator = generator
    try:
        yield
    finally:
        _DropoutRng.generator = prev


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with probability
    1 - p and divide it by 1 - p; the mask comes from the generator that
    :func:`dropout_generator` installed, and a train-mode call without one
    raises. Inert in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = _DropoutRng.generator
        if gen is None:
            raise RuntimeError("train-mode dropout needs a torch.Generator: run the forward "
                               "with DeformSegmentation(..., train=True, rng=generator)")
        keep = 1.0 - self.p
        return x * _keep_mask(x.shape, x, keep, gen) / keep


class DropPath(nn.Module):
    """Stochastic depth of the JAX package's ``SegformerLayer``: in train mode
    keep each sample of ``[B, ...]`` with probability 1 - p (one draw per
    sample from the dropout generator) and divide it by 1 - p."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = _DropoutRng.generator
        if gen is None:
            raise RuntimeError("train-mode drop path needs a torch.Generator: run the forward "
                               "with DeformSegmentation(..., train=True, rng=generator)")
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return x * _keep_mask(shape, x, keep, gen) / keep


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis: mean and E[x^2] in f32, the
    variance E[x^2] - mean^2 clipped at 0, then ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in f32, cast to ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x):
        xf = at_least_f32(x)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype)


class BatchStatsNorm(nn.Module):
    """The JAX package's ``_BatchStatsNorm`` (torch ``BatchNorm2d`` with
    ``track_running_stats=False``): normalise each channel of an NCHW map with
    the current batch's mean and variance in train and eval alike, the
    variance as E[x^2] - mean^2 in f32; learned scale and bias, no running
    statistics. So a served output depends on which frames share its
    batch, as in the reference.

    ``process_group`` (set by :func:`set_batch_stats_group`): the statistics
    of the batch that the ranks of the group hold together, from one
    all-reduce of the f32 sums of x and x^2 and the count (the gradient
    flows through it, :class:`_RankSum`)."""

    eps = 1e-5

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.compute_dtype = dtype
        self.process_group = None

    def forward(self, x):
        xf = at_least_f32(x)
        if self.process_group is None:
            mean = xf.mean(dim=(0, 2, 3), keepdim=True)
            var = xf.square().mean(dim=(0, 2, 3), keepdim=True) - mean.square()
        else:
            c = x.shape[1]
            count = xf.new_full((1,), x.numel() // c)
            sums = _RankSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)),
                                             xf.square().sum(dim=(0, 2, 3)), count]),
                                  self.process_group)
            mean = (sums[:c] / sums[-1]).view(1, c, 1, 1)
            var = (sums[c:2 * c] / sums[-1]).view(1, c, 1, 1) - mean.square()
        w, b = self.weight.view(1, -1, 1, 1), self.bias.view(1, -1, 1, 1)
        return ((xf - mean) * torch.rsqrt(var + self.eps) * w + b).to(self.compute_dtype)


class RowHooks:
    """The row-partitioned trunk that is running, if any
    (``parallel/spatial.py::RowShards.running``). While one runs, the
    encoder's and decoder's convs (swapped for ``spatial.RowConv2d``), their
    resizes (:func:`trunk_resize`), global means (:func:`trunk_mean`), max
    pools (:func:`trunk_max_pool`) and whole-map gathers
    (:func:`trunk_gather`) take their row blocks through it."""

    active = None


def trunk_resize(x: torch.Tensor, size) -> torch.Tensor:
    """``resize_bilinear_nchw(x, size)``; inside a row-partitioned trunk,
    this rank's rows of it (``size`` then being the local rows' size)."""
    if RowHooks.active is not None:
        return RowHooks.active.resize(x, size)
    return resize_bilinear_nchw(x, size)


def trunk_mean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over (H, W), [B, C] (``keepdim``: [B, C, 1, 1]); inside a
    row-partitioned trunk, that of the whole tensor whose rows the ranks
    hold."""
    if RowHooks.active is not None:
        return RowHooks.active.mean(x, keepdim)
    return torch.mean(x, dim=(2, 3), keepdim=keepdim)


def trunk_max_pool(x: torch.Tensor, kernel_size: int, stride: int, padding: int) -> torch.Tensor:
    """``torch.max_pool2d``; inside a row-partitioned trunk, this rank's
    rows of it."""
    if RowHooks.active is not None:
        return RowHooks.active.max_pool(x, kernel_size, stride, padding)
    return torch.max_pool2d(x, kernel_size, stride, padding)


def trunk_gather(x: torch.Tensor, hw=None) -> torch.Tensor:
    """``x`` itself; inside a row-partitioned trunk, the whole map on every
    rank from the ranks' row blocks. ``x``: an NCHW map, or with ``hw`` the
    row-major tokens [B, h * W, C] of the local map of size ``hw``."""
    rows = RowHooks.active
    if rows is None:
        return x
    if hw is None:
        return rows.gather(x)
    b, _, c = x.shape
    whole = rows.gather(x.transpose(1, 2).reshape(b, c, *hw))
    return whole.flatten(2).transpose(1, 2)


@contextlib.contextmanager
def whole_tensors():
    """Inside a row-partitioned trunk, run the block on a tensor that every
    rank holds whole (DeepLab's pooled image vector): its convs and hooks
    take no row blocks."""
    rows, RowHooks.active = RowHooks.active, None
    try:
        yield
    finally:
        RowHooks.active = rows


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to at least f32 (flax's ``promote_types(dtype, float32)``:
    f64 stays f64)."""
    return x if x.dtype == torch.float64 else x.float()


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Linear(_CastCache, nn.Linear):
    """``nn.Linear`` computing in ``dtype``; ``init`` names its weight init
    (``"kaiming_normal"``, the JAX package's ``linear``, or
    ``"xavier_uniform"``, SegFormer's ``Dense``)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 init: str = "kaiming_normal"):
        super().__init__(cin, cout)
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self._cast_param("weight", self.weight),
                        self._cast_param("bias", self.bias))


def conv2d(cin: int, cout: int, kernel_size: int = 3, stride: int = 1, padding: int = 0,
           use_bias: bool = True, dtype: torch.dtype = torch.float32, dilation: int = 1,
           groups: int = 1, quantizable: bool = True) -> Conv2d:
    return Conv2d(cin, cout, kernel_size, stride, padding, use_bias, dtype, dilation, groups,
                  quantizable)


def batch_norm(channels: int, dtype: torch.dtype = torch.float32) -> BatchNorm2d:
    return BatchNorm2d(channels, dtype)


def linear(cin: int, cout: int, dtype: torch.dtype = torch.float32,
           init: str = "kaiming_normal") -> Linear:
    return Linear(cin, cout, dtype, init)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init mirroring the JAX package's initializers."""
    for m in module.modules():
        if getattr(m, "init", None) == "xavier_uniform":
            fan_out, fan_in = m.weight.shape
            w = torch.rand(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_((2.0 * w - 1.0) * math.sqrt(6.0 / (fan_in + fan_out)))
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_(w * math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchStatsNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.fill_(1e-4)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return module
