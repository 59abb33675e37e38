"""Column-parallel layers of the 2-D mesh (the port's counterpart of the
'model' axis of ``fovealseg_tpu/parallel/mesh.py``'s GSPMD step).

A layer whose weight ``parallel/mesh.py::model_sharded`` selects holds only
its block of output channels on each model rank: rank m of ``parts`` holds
``[m * C / parts, (m + 1) * C / parts)``. Its forward is Megatron's
column-parallel layer with a gathered output:

* :class:`_ReplicatedInput` (the input side): the identity forward; its
  backward all-reduces the input gradient over the model group, since each
  rank's gradient is the partial sum through its own output channels;
* the local convolution (or matrix product) with the shard, no bias;
* :class:`_GatheredOutput` (the output side): all-gather over the model
  group and concatenate along channels, so that every rank holds the
  unsharded output in the unsharded channel order; its backward keeps this
  rank's slice of the upstream gradient. (``torch.distributed.nn``'s
  all-gather sums over the ranks in its backward, which would give ``parts``
  times the gradient: every model rank holds the same upstream gradient.)
* the bias, 1-D and so replicated as in JAX, added to the gathered output,
  so that its gradient is the same on every model rank.

A grouped conv (SegFormer's depthwise conv) shards its groups: rank m runs
``groups / parts`` groups on its block of input channels.

:func:`column_parallel` swaps the layers of a model in place; parameter
names and order stay, so the state-dict keys and the optimizer's groups are
those of the unsharded model, with shard-sized weights. Each sharded weight
carries ``model_shard = (m, parts)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from fovealseg_torch.models.layers import Conv2d, Linear
from fovealseg_torch.parallel.mesh import all_gather_tensors, model_sharded


class _ReplicatedInput(torch.autograd.Function):
    """The identity forward; the backward sums the input gradient over the
    model group (in f32 for 16-bit floats)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32) if grad.dtype in (torch.bfloat16, torch.float16) else grad
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _GatheredOutput(torch.autograd.Function):
    """All-gather over the model group, concatenated along ``dim``; the
    backward keeps this rank's slice of the upstream gradient."""

    @staticmethod
    def forward(ctx, y, dim, group, index):
        ctx.dim, ctx.index, ctx.size = dim, index, y.shape[dim]
        return torch.cat(all_gather_tensors(y, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None, None


class _ColumnParallel:
    """What the two layers share: the shard's place and the bias after the
    gather."""

    def _setup(self, group, index: int, parts: int, bias: torch.Tensor | None):
        self.group, self.index, self.parts = group, index, parts
        self.weight.model_shard = (index, parts)
        # the replicated bias, added after the gather
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone())

    def _gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        y = _GatheredOutput.apply(y, dim, self.group, self.index)
        if self.bias is None:
            return y
        shape = [1] * y.dim()
        shape[dim] = -1
        return y + self._cast_param("bias", self.bias).view(shape)


class ColumnParallelConv2d(_ColumnParallel, Conv2d):
    """``layers.Conv2d`` holding its block of output channels."""

    def __init__(self, conv: Conv2d, group, index: int, parts: int):
        cout = conv.out_channels // parts
        groups = conv.groups
        if groups > 1 and groups % parts:
            raise NotImplementedError(f"a conv of {groups} groups does not shard over {parts} "
                                      "model ranks")
        cin = conv.in_channels // parts if groups > 1 else conv.in_channels
        super().__init__(cin, cout, conv.kernel_size, conv.stride, conv.padding, bias=False,
                         dtype=conv.compute_dtype, dilation=conv.dilation,
                         groups=groups // parts if groups > 1 else 1)
        self.to(conv.weight.device, conv.weight.dtype)
        with torch.no_grad():
            self.weight.copy_(conv.weight[index * cout:(index + 1) * cout])
        # the input block of a grouped conv's shard
        self.in_block = (index * cin, (index + 1) * cin) if groups > 1 else None
        self._setup(group, index, parts, conv.bias)

    def forward(self, x):
        x = _ReplicatedInput.apply(x, self.group)
        if self.in_block is not None:
            x = x[:, self.in_block[0]:self.in_block[1]]
        y = F.conv2d(x.to(self.compute_dtype), self._cast_param("weight", self.weight), None,
                     self.stride, self.padding, self.dilation, self.groups)
        return self._gather(y, 1)


class ColumnParallelLinear(_ColumnParallel, Linear):
    """``layers.Linear`` holding its block of output features."""

    def __init__(self, lin: Linear, group, index: int, parts: int):
        cout = lin.out_features // parts
        super().__init__(lin.in_features, cout, lin.compute_dtype, lin.init)
        self.to(lin.weight.device, lin.weight.dtype)
        with torch.no_grad():
            self.weight.copy_(lin.weight[index * cout:(index + 1) * cout])
        self._setup(group, index, parts, lin.bias)

    def forward(self, x):
        x = _ReplicatedInput.apply(x, self.group)
        y = F.linear(x.to(self.compute_dtype), self._cast_param("weight", self.weight))
        return self._gather(y, -1)


def column_parallel(model: nn.Module, group, index: int, parts: int,
                    min_channels: int = 256) -> int:
    """Swap in place every ``layers.Conv2d`` and ``layers.Linear`` of ``model``
    whose weight ``model_sharded`` selects for its column-parallel shard on
    model rank ``index`` of ``parts``. Any other module holding a selected
    tensor raises. Returns the number of layers swapped."""
    swaps = []
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if not model_sharded(pname, p, parts, min_channels):
                continue
            if type(module) is Conv2d:
                swaps.append((name, ColumnParallelConv2d))
            elif type(module) is Linear:
                swaps.append((name, ColumnParallelLinear))
            else:
                raise NotImplementedError(f"{name}.{pname} ({type(module).__name__}) is wide "
                                          "enough to shard and has no column-parallel layer")
    for name, cls in swaps:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, child, cls(getattr(parent, child), group, index, parts))
    return len(swaps)
