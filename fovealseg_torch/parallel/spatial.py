"""Row-partitioned execution of one frame's trunk (counterpart of the JAX
package's spatial partitioning: ``fovealseg_tpu/parallel/mesh.py::
make_spatial_infer_fn`` and the ``spatial_sharding`` of its
``DeformSegmentation``).

At batch 1 there is no batch to split, so N ranks split the warped task
image's rows. The JAX package constrains the rows over a 1-D 'spatial' mesh
and lets XLA insert the halo exchanges; here :class:`RowShards` does it by
hand for every encoder of the builder (HRNetV2, SegFormer-B5,
DeepLabV3-R101) and C1. Their own forwards run unchanged on each rank's
rows: :func:`row_aware` swaps their convs for :class:`RowConv2d`, and the
ops that reach across rows go through hooks in ``models/layers.py``: the
resizes (``trunk_resize``: HRNetV2's fuse and output, SegFormer's stage
maps, DeepLab's output), the global means (``trunk_mean``: C1's class
branch, DeepLab's image pool), DeepLab's stem max pool
(``trunk_max_pool``) and SegFormer's keys and values (``trunk_gather``).
While a trunk runs (:meth:`RowShards.running`) these take their row blocks
through it:

* every tensor of global height n is split into the same blocks: rank r
  owns ``[ceil(a_r * n / H), ceil(b_r * n / H))`` where ``[a_r, b_r)`` is its
  block of the task image's H rows (:meth:`RowShards.block`). The blocks of
  the coarser levels are so derived from the finest, which keeps a stride-2
  or stride-4 conv's input rows next to its output rows. Blocks may be
  uneven or empty (10 rows at the flagship's 1/8 level over 4 ranks: 3, 2,
  3, 2; 2 rows at the tiny 16x16 shape's 1/8 level over 4 ranks: 1, 0, 1,
  0), and every op takes an empty block;
* each op fetches the input rows its output block needs (:meth:`_fetch`): a
  k x k conv or max pool of stride s the rows ``[s * c - p, s * (d - 1) - p
  + k)`` of its output block ``[c, d)``, rows outside the image zero for a
  conv and -inf for a pool; the bilinear up-resize (a dense matrix,
  ``core/interpolate.py``) the source rows under its block's support. The
  exchange is one all-gather of fixed-size boundary slabs (each rank's
  first and last rows, as many as any rank needs of another): it runs on
  gloo with CPU and CUDA tensors and on NCCL, a rank may read from more
  than one neighbour (DeepLab's rate-36 ASPP taps over a 10-row map read
  every rank's block), and there is no send/recv ordering to deadlock. An
  op whose blocks need no other rank's rows exchanges nothing (1x1 convs,
  SegFormer's reduction convs where the blocks align);
* a global mean is the local rows' sum, all-reduced, over the global count
  (:meth:`mean`); DeepLab's image-pool branch then runs on the pooled
  vector, whole on every rank (``layers.whole_tensors``);
* SegFormer's attention keeps its queries on the local tokens and attends
  to the keys and values of the whole map, gathered (:meth:`gather`) on
  every rank;
* the decoder's output is gathered whole before the inverse warp;
* a tensor's global height, which its row block does not tell, is the sum
  of the ranks' block heights: all-reduced at each op of a task height's
  first frame and then read in call order (:meth:`global_height`; every
  frame runs the same ops).

BN in eval mode, ReLU, GELU, LayerNorm, the ``Linear`` layers, dropout in
eval mode and the residual adds are per pixel or per token and run on the
local rows. Only inference runs row-partitioned
(``DeformSegmentation.forward(train=False)`` and ``infer``).
:data:`exchanges` counts the collectives, as the kernel wrappers count
their launches.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from fovealseg_torch.core.interpolate import (_linear_resize_matrix, _resize,
                                              _resize_matrix, full_f32_matmul)
from fovealseg_torch.models.layers import Conv2d, RowHooks
from fovealseg_torch.parallel.mesh import all_gather_tensors

# collectives issued by row-partitioned trunks in this process
exchanges = 0

def _count() -> None:
    global exchanges
    exchanges += 1


@functools.lru_cache(maxsize=4096)
def _blocks(height: int, world: int, n: int) -> tuple:
    top = [-(-r * height // world) for r in range(world + 1)]  # the task image's blocks
    edge = [-(-t * n // height) for t in top]
    return tuple(zip(edge[:-1], edge[1:]))


@functools.lru_cache(maxsize=4096)
def _plan(height: int, world: int, rank: int, n: int, needs: tuple) -> tuple:
    """(top, bottom, index): the slab heights that every rank sends (its first
    ``top`` and last ``bottom`` rows) and the rows of [a zero row, the own
    block, every rank's slabs] that make ``rank``'s needed rows. ``needs``:
    each rank's needed rows ``(lo, hi)``, or None."""
    blocks = _blocks(height, world, n)
    top = bottom = 0
    for r, need in enumerate(needs):
        if need is None:
            continue
        lo, hi = max(need[0], 0), min(need[1], n)
        for s, (a, b) in enumerate(blocks):
            olo, ohi = max(lo, a), min(hi, b)
            if s == r or olo >= ohi:
                continue
            # rows that touch the owner's first row come from its top slab, rows
            # that touch its last from its bottom slab, others from the nearer
            if olo == a or (ohi != b and ohi - a <= b - olo):
                top = max(top, ohi - a)
            else:
                bottom = max(bottom, b - olo)
    a, b = blocks[rank]
    slab = top + bottom
    index = []
    for j in range(*needs[rank]) if needs[rank] is not None else ():
        if j < 0 or j >= n:
            index.append(0)
        elif a <= j < b:
            index.append(1 + j - a)
        else:
            s = next(s for s, (sa, sb) in enumerate(blocks) if sa <= j < sb)
            sa, sb = blocks[s]
            base = 1 + (b - a) + s * slab
            if j - sa < top:
                index.append(base + j - sa)
            else:
                assert sb - j <= bottom, (j, s, top, bottom)
                index.append(base + slab - (sb - j))
    return top, bottom, tuple(index)


@functools.lru_cache(maxsize=4096)
def _resize_needs(height: int, world: int, n: int, n_out: int) -> tuple:
    """Each rank's source rows of the bilinear resize n -> n_out."""
    m = _linear_resize_matrix(n, n_out)
    needs = []
    for c, d in _blocks(height, world, n_out):
        cols = np.nonzero(m[c:d].any(axis=0))[0]
        needs.append((int(cols[0]), int(cols[-1]) + 1) if d > c and cols.size else None)
    return tuple(needs)


class RowShards:
    """The row blocks of one frame's trunk over the ranks of ``group``."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.height = 0  # the task image's rows, while a trunk runs
        self._learned: dict = {}  # task height -> [(local rows, global rows)] in call order
        self._seq: list = []
        self._cursor = 0

    @contextlib.contextmanager
    def running(self, height: int):
        """The row-aware ops of the block take their row blocks through this
        object, for a task image of ``height`` rows."""
        if RowHooks.active is not None:
            raise RuntimeError("a row-partitioned trunk is already running")
        self.height = height
        self._seq = self._learned.setdefault(height, [])
        self._cursor = 0
        RowHooks.active = self
        try:
            yield self
        finally:
            RowHooks.active = None

    def global_height(self, h: int, device) -> int:
        """The global height of the tensor of which this rank holds ``h`` rows
        (on ``device``) at the trunk's next op: collective on a task height's
        first frame."""
        i = self._cursor
        self._cursor += 1
        if i == len(self._seq):
            n = torch.tensor([h], dtype=torch.int64, device=device)
            dist.all_reduce(n, group=self.group)
            _count()
            self._seq.append((h, int(n)))
        local, n = self._seq[i]
        if local != h:
            raise RuntimeError(f"op {i} of the trunk holds {h} rows, {local} on the first frame")
        return n

    def blocks(self, n: int) -> tuple:
        """Every rank's block ``(lo, hi)`` of a tensor of global height ``n``."""
        return _blocks(self.height, self.world, n)

    def block(self, n: int) -> tuple[int, int]:
        return self.blocks(n)[self.rank]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole NCHW tensor of the task image's height."""
        lo, hi = self.block(x.shape[2])
        return x[:, :, lo:hi]

    def _fetch(self, x: torch.Tensor, n: int, needs: tuple, fill: float = 0.0) -> torch.Tensor:
        """This rank's needed rows of the tensor whose local block is ``x``
        (global height ``n``), rows off the image filled with ``fill``:
        collective, every rank passes the same ``needs``."""
        top, bottom, index = _plan(self.height, self.world, self.rank, n, needs)
        b, c, h, w = x.shape
        parts = [x.new_full((b, c, 1, w), fill), x]
        if top + bottom:
            slab = torch.cat([x[:, :, :top], x.new_zeros(b, c, max(top - h, 0), w),
                              x.new_zeros(b, c, max(bottom - h, 0), w),
                              x[:, :, max(h - bottom, 0):]], dim=2)
            parts += all_gather_tensors(slab, self.group)
            _count()
        src = torch.cat(parts, dim=2)
        return src.index_select(2, torch.tensor(index, dtype=torch.int64, device=x.device))

    # --------------------------------------------------------------------- ops
    def _window_rows(self, x: torch.Tensor, k: int, s: int, p: int,
                     fill: float = 0.0) -> torch.Tensor | None:
        """The input rows of this rank's output block of a sliding window
        (over rows: extent ``k`` with the dilation, stride ``s``, padding
        ``p``) on the tensor whose local block is ``x``: the rows ``[s * c -
        p, s * (d - 1) - p + k)`` of output block ``[c, d)``; None for an
        empty block (collective all the same)."""
        n = self.global_height(x.shape[2], x.device)
        n_out = (n + 2 * p - k) // s + 1
        needs = tuple((s * c - p, s * (d - 1) - p + k) if d > c else None
                      for c, d in self.blocks(n_out))
        rows = self._fetch(x, n, needs, fill)
        return rows if needs[self.rank] is not None else None

    def conv(self, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        """``conv`` on the local rows: this rank's rows of its output."""
        k = conv.dilation[0] * (conv.kernel_size[0] - 1) + 1
        rows = self._window_rows(x, k, conv.stride[0], conv.padding[0])
        if rows is None:
            wk = conv.dilation[1] * (conv.kernel_size[1] - 1) + 1
            w_out = (x.shape[3] + 2 * conv.padding[1] - wk) // conv.stride[1] + 1
            return x.new_zeros(x.shape[0], conv.out_channels, 0, w_out, dtype=conv.compute_dtype)
        return F.conv2d(rows.to(conv.compute_dtype), conv._cast_param("weight", conv.weight),
                        conv._cast_param("bias", conv.bias), conv.stride, (0, conv.padding[1]),
                        conv.dilation, conv.groups)

    def resize(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        """``resize_bilinear_nchw`` of the tensor whose local block is ``x`` to
        the size whose local rows are ``out_hw``: this rank's output rows."""
        n = self.global_height(x.shape[2], x.device)
        n_out = self.global_height(out_hw[0], x.device)
        w_out = out_hw[1]
        if n_out == n:
            return _resize(x, (x.shape[2], w_out), 2)
        needs = _resize_needs(self.height, self.world, n, n_out)
        src = self._fetch(x, n, needs)
        c, d = self.block(n_out)
        lo, hi = needs[self.rank] or (0, 0)
        rows = _resize_matrix(n, n_out, x.device, x.dtype)[c:d, lo:hi]
        with full_f32_matmul():
            y = torch.matmul(rows, src.to(torch.float32).movedim(2, -2)).movedim(-2, 2)
        if x.dtype != torch.float32:
            y = y.to(x.dtype)  # the per-axis rounding of core/interpolate.py
        return _resize(y, (y.shape[2], w_out), 2).to(x.dtype)

    def max_pool(self, x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
        """``torch.max_pool2d(x, k, s, p)`` on the local rows: this rank's
        rows of its output. Rows off the image are -inf, as the whole pool's
        padding is."""
        rows = self._window_rows(x, k, s, p, fill=float("-inf"))
        if rows is None:
            w_out = (x.shape[3] + 2 * p - k) // s + 1
            return x.new_zeros(x.shape[0], x.shape[1], 0, w_out)
        return torch.max_pool2d(rows, k, s, (0, p))

    def mean(self, x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        """The mean over (H, W) of the whole tensor: the local rows' f32 sum,
        all-reduced, over the global count. [B, C] (``keepdim``: [B, C, 1,
        1]) in ``x``'s dtype."""
        n = self.global_height(x.shape[2], x.device)
        total = x.to(torch.float32).sum(dim=(2, 3), keepdim=keepdim)
        dist.all_reduce(total, group=self.group)
        _count()
        return (total / (n * x.shape[3])).to(x.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor (on every rank) from each rank's block."""
        blocks = self.blocks(self.global_height(x.shape[2], x.device))
        tall = max(hi - lo for lo, hi in blocks)
        pad = x.new_zeros(x.shape[0], x.shape[1], tall - x.shape[2], x.shape[3])
        parts = all_gather_tensors(torch.cat([x, pad], dim=2), self.group)
        _count()
        return torch.cat([p[:, :, :hi - lo] for p, (lo, hi) in zip(parts, blocks)], dim=2)


class RowConv2d(Conv2d):
    """A ``layers.Conv2d`` that, inside a row-partitioned trunk, convolves
    this rank's rows (:meth:`RowShards.conv`) and otherwise the whole input."""

    def forward(self, x):
        if RowHooks.active is None:
            return super().forward(x)
        return RowHooks.active.conv(self, x)


def row_aware(module: nn.Module) -> int:
    """Swap every ``layers.Conv2d`` of ``module`` for a :class:`RowConv2d`
    in place (the same parameters and keys); raises for another conv.
    Returns the number of convs swapped."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and type(m) not in (Conv2d, RowConv2d):
            raise NotImplementedError(f"row-partitioned {type(m).__name__}")
    convs = [m for m in module.modules() if type(m) is Conv2d]
    for m in convs:
        m.__class__ = RowConv2d
    return len(convs)


def run_trunk(encoder: nn.Module, decoder: nn.Module, x: torch.Tensor,
              rows: RowShards) -> torch.Tensor:
    """The encoder and decoder (made :func:`row_aware`) on ``x`` [B, 3, H, W]
    (whole on every rank), row-partitioned over ``rows``' group; returns the
    decoder's output whole."""
    if encoder.training or decoder.training or torch.is_grad_enabled():
        raise RuntimeError("row-partitioned execution is inference only (eval mode, no "
                           "gradients)")
    with rows.running(x.shape[2]):
        return rows.gather(decoder(encoder(rows.shard(x))))
