"""DeformSegmentation: the foveation pipeline (counterpart of
``fovealseg_tpu/models/deform_module.py``).

  gaze distance map -> 5ch saliency input -> FovSim + Compress -> softmax
  saliency -> replication pad -> Gaussian grid solver -> forward warp of the
  image -> encoder/decoder -> 51ch logits [-> full-res argmax labels].

The four sub-networks are the submodules ``localization``, ``net_compress``,
``encoder`` and ``decoder``, so ``state_dict()`` keys carry the same four
prefixes as the JAX package's parameter subtrees. Public tensors keep the JAX
layouts (images [B,H,W,3], grids [B,h,w,2], logits [B,h,w,C]); the
sub-networks run NCHW.

``forward`` is the JAX module's ``__call__``: the eval forward, and with
``train=True`` the training forward (batch-statistics BN that updates the
running statistics, dropout from an explicit generator) with gradients,
``xs_override``, the Recasens pretrain pool (``pool_s``) and
``MODEL.loss_at_high_res`` (the prediction inverse-warped to full
resolution: a plain bilinear upsample for the uniform 'BI' baseline, the
payload flood + row gather for 'nearest', the inverse grid + splat fill for
'BI'/'tri'; gradients reach the prediction through the row gather's
backward). The saliency overrides stop the gradient where the JAX module
does. ``infer`` (argmax labels and full-res score maps in every
``rev_deform_interp``, the round trips, the uniform baselines,
``VAL.F_Xlr_low_scale > 1``, ``MODEL.gt_gradient``) runs in eval mode
under ``no_grad``. ``TPU.scoremap_gather_bf16`` rounds the score map's
rows to bf16 before the row gather, as the JAX package does.

:meth:`DeformSegmentation.set_spatial` (the counterpart of the JAX module's
``spatial_sharding``, ``_shard_rows`` and ``_replicate``): the eval forward
and ``infer`` split the warped image's rows over the ranks of a process
group right before the encoder, run the encoder and the decoder on row
blocks (``parallel/spatial.py``) and gather the decoder's output whole
before the inverse warp. The saliency net, the grid, the warp, the scatter
and the jump flood run whole on every rank. Every encoder of the builder
(HRNetV2, SegFormer-B5, DeepLabV3-R101) with C1.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn as nn

from fovealseg_torch import resolve_device
from fovealseg_torch.core.edges import edge_target_pil_style
from fovealseg_torch.core.gaze import focus_distance_map
from fovealseg_torch.core.grid import (
    GridSolver,
    grid_from_index,
    inverse_grid_index,
    pad_saliency,
)
from fovealseg_torch.core.interpolate import (
    _area_resize_matrix,
    _linear_resize_matrix,
    eager_cache,
    full_f32_matmul,
    resize_bilinear,
    resize_bilinear_nchw,
    resize_nearest,
)
from fovealseg_torch.core.unwarp import (
    fill_values_splat,
    jfa_rounds_from_grid,
    unwarp_argmax_scatter,
    unwarp_labels_fast,
    unwarp_prediction,
    unwarp_prediction_fast,
)
from fovealseg_torch.core.warp import grid_sample
from fovealseg_torch.models.layers import dropout_generator


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    """Static geometry/config snapshot: the JAX package's DeformConfig fields,
    with the same defaults."""

    task_hw: tuple[int, int] = (80, 80)
    task_hw_infer: tuple[int, int] = (80, 80)
    saliency_hw: tuple[int, int] = (80, 80)
    num_class: int = 51
    segm_downsampling_rate: int = 1
    gaussian_radius: int = 45
    gaussian_ap: float = 0.0
    saliency_output_size_short: int = 0
    pad_mode: str = "replication"
    saliency_net: str = "fovsimple"
    arch_encoder: str = "hrnetv2_nodownsp"
    arch_decoder: str = "c1"
    fc_dim: int = 960
    rev_deform_interp: str = "nearest"
    uniform_sample: str = ""
    f_xlr_low_scale: int = 0
    jfa_iters: int = 0  # 0 = derive the round count from the grid at runtime
    scoremap_gather: str = "xla"  # TPU.scoremap_gather: both values take K5
    scoremap_gather_bf16: bool = False  # TPU.scoremap_gather_bf16
    # MODEL.gt_gradient family: with labels, detach the saliency; with
    # fix_gt_gradient replace it by the label-edge sampler
    gt_gradient: bool = False
    fix_gt_gradient: bool = False
    ignore_gt_labels: tuple = ()  # MODEL.ignore_gt_labels -> mapped to 0
    gt_grad_blur_r: float = 1.0  # MODEL.gt_grad_gaussian_blur_r
    deform_zero_bound: int = 0  # TRAIN.deform_zero_bound(_factor)
    loss_at_high_res: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "DeformConfig":
        task = tuple(cfg.TRAIN.task_input_size)
        task_eval = tuple(cfg.TRAIN.task_input_size_eval)
        return cls(
            task_hw=task,
            task_hw_infer=task_eval if len(task_eval) else task,
            saliency_hw=tuple(cfg.TRAIN.saliency_input_size),
            num_class=cfg.DATASET.num_class,
            segm_downsampling_rate=cfg.DATASET.segm_downsampling_rate,
            gaussian_radius=cfg.MODEL.gaussian_radius,
            gaussian_ap=cfg.MODEL.gaussian_ap,
            saliency_output_size_short=cfg.MODEL.saliency_output_size_short,
            pad_mode=cfg.TRAIN.def_saliency_pad_mode,
            saliency_net=cfg.MODEL.saliency_net,
            arch_encoder=cfg.MODEL.arch_encoder,
            arch_decoder=cfg.MODEL.arch_decoder,
            fc_dim=cfg.MODEL.fc_dim,
            rev_deform_interp=cfg.MODEL.rev_deform_interp,
            uniform_sample=cfg.MODEL.uniform_sample,
            f_xlr_low_scale=cfg.VAL.F_Xlr_low_scale,
            jfa_iters=cfg.TPU.jfa_iters,
            scoremap_gather=cfg.TPU.scoremap_gather,
            scoremap_gather_bf16=cfg.TPU.scoremap_gather_bf16,
            gt_gradient=cfg.MODEL.gt_gradient,
            fix_gt_gradient=cfg.MODEL.fix_gt_gradient,
            ignore_gt_labels=tuple(cfg.MODEL.ignore_gt_labels),
            gt_grad_blur_r=float(cfg.MODEL.gt_grad_gaussian_blur_r),
            deform_zero_bound=(cfg.TRAIN.deform_zero_bound_factor
                               if cfg.TRAIN.deform_zero_bound else 0),
            loss_at_high_res=cfg.MODEL.loss_at_high_res,
        )

    def solver(self) -> GridSolver:
        sal_h, sal_w = self.saliency_hw
        grid_h = self.saliency_output_size_short or sal_h
        grid_w = sal_w // (sal_h // grid_h)
        pad_x = self.gaussian_radius
        ap = self.gaussian_ap if self.gaussian_ap != 0.0 else sal_w // sal_h
        return GridSolver(grid_h, grid_w, pad_x, int(ap * pad_x), float(self.gaussian_radius))


@eager_cache(maxsize=64)
def _pool_operator(size: int, s: int, device: torch.device) -> torch.Tensor:
    """``U_s @ P_s`` [size, size]: adaptive average pooling (size -> s) then
    the bilinear resize back (s -> size), one axis of the Recasens pretrain
    pool."""
    m = _linear_resize_matrix(s, size) @ _area_resize_matrix(size, s)
    return torch.from_numpy(np.ascontiguousarray(m, dtype=np.float32)).to(device)


def pretrain_pool(x_sampled: torch.Tensor, pool_s: int, saliency_hw) -> torch.Tensor:
    """The Recasens pretrain augmentation: pool the warped image to (s, s) and
    upsample it back, with s clipped to [min(saliency_hw) // 3, min(saliency_hw)]
    as the JAX package's operator stack clips it. x_sampled [B, th, tw, 3]."""
    s_min = max(min(saliency_hw) // 3, 1)
    s = min(max(int(pool_s), s_min), min(saliency_hw))
    ar = _pool_operator(x_sampled.shape[1], s, x_sampled.device)
    ac = _pool_operator(x_sampled.shape[2], s, x_sampled.device)
    with full_f32_matmul():
        xa = torch.einsum("ij,bjwc->biwc", ar, x_sampled.to(torch.float32))
        xa = torch.einsum("ij,bhjc->bhic", ac, xa)
    return xa.to(x_sampled.dtype)


class DeformSegmentation(nn.Module):
    """Foveation + segmentation: the training and eval forwards and
    full-resolution inference.

    ``dtype`` is the sub-networks' compute dtype (params stay f32), as the
    JAX module's ``dtype``. ``device`` defaults to ``cuda`` and raises when
    no card is present; pass ``device="cpu"`` to run on the host."""

    def __init__(self, config: DeformConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        from fovealseg_torch.models.builder import (
            build_decoder,
            build_encoder,
            build_net_compress,
            build_net_saliency,
        )

        self.device = resolve_device(device)
        self.config = c = config
        self.dtype = dtype
        self.localization = build_net_saliency(c.saliency_net, dtype)
        self.net_compress = build_net_compress(c.saliency_net, dtype)
        self.encoder = build_encoder(c.arch_encoder, c.fc_dim, dtype)
        self.decoder = build_decoder(c.arch_decoder, c.fc_dim, c.num_class, dtype)
        self.spatial_rows = None
        self.to(self.device)
        self.eval()

    def set_spatial(self, group) -> None:
        """Run the encoder and the decoder of inference row-partitioned over
        the ranks of ``group`` (None: whole). Each rank holds the whole frame
        batch. A net with a conv that ``spatial.row_aware`` cannot swap
        raises."""
        from fovealseg_torch.parallel import spatial

        self.spatial_rows = None
        if group is None:
            return
        spatial.row_aware(nn.ModuleList([self.encoder, self.decoder]))
        self.spatial_rows = spatial.RowShards(group)

    @contextlib.contextmanager
    def _mode(self, train: bool):
        """Run the block with the sub-networks in train or eval mode, and
        restore the mode after it."""
        if self.training == train:
            yield
            return
        self.train(train)
        try:
            yield
        finally:
            self.train(not train)

    def saliency(self, x: torch.Tensor, focus_point: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
        """Image + gaze -> softmax saliency map [B, gh, gw, 1]. At inference
        (``train=False``) ``VAL.F_Xlr_low_scale > 1`` divides the saliency
        input size."""
        c = self.config
        solver = c.solver()
        sal_hw = c.saliency_hw
        if not train and c.f_xlr_low_scale > 1:
            sal_hw = (sal_hw[0] // c.f_xlr_low_scale, sal_hw[1] // c.f_xlr_low_scale)
        x_low = resize_bilinear(x, sal_hw)
        fm = focus_distance_map(focus_point, *sal_hw).to(x.dtype)
        x5 = torch.cat([x_low, fm, fm], dim=-1).permute(0, 3, 1, 2)
        xs = self.net_compress(self.localization(x5))
        xs = resize_bilinear_nchw(xs, (solver.grid_h, solver.grid_w))
        b = xs.shape[0]
        flat = xs.reshape(b, -1).to(torch.float32)
        return torch.softmax(flat, dim=-1).reshape(b, solver.grid_h, solver.grid_w, 1)

    def _apply_overrides(self, xs: torch.Tensor, y=None, xs_override=None) -> torch.Tensor:
        """The saliency overrides of the JAX module, in its order: first
        ``MODEL.gt_gradient``, only when labels are given (without them the
        saliency passes through): with ``fix_gt_gradient`` the label-edge
        sampler replaces the saliency (except for the uniform-'BI' binary
        config, as in the reference), else the zero-bound border mask
        applies; then the ``MODEL.uniform_sample`` flattening. An override
        (``xs_override``, or ``MODEL.gt_gradient`` with labels) carries no
        gradient to the saliency nets, as in the JAX module."""
        c = self.config
        if xs_override is not None:
            xs = xs_override.detach()
        elif c.gt_gradient and y is not None:
            if c.fix_gt_gradient and not (c.uniform_sample == "BI" and c.num_class == 2):
                yy = y.to(torch.float32)
                for k in c.ignore_gt_labels:
                    yy = torch.where(yy == k, 0.0, yy)
                xs = edge_target_pil_style(
                    yy, c.saliency_hw, (xs.shape[1], xs.shape[2]), c.gt_grad_blur_r,
                    softmax=False, zero_bound=c.deform_zero_bound).to(xs.dtype).detach()
            else:
                xs = xs.detach()
                if c.deform_zero_bound:
                    bound = c.deform_zero_bound
                    mask = torch.zeros_like(xs)
                    mask[:, bound:-bound, bound:-bound, :] = 1.0
                    xs = xs * mask
        if c.uniform_sample != "":
            xs = torch.full_like(xs, 1.0 / (xs.shape[1] * xs.shape[2]))
        return xs

    def grids(self, xs: torch.Tensor, task_hw=None, label_hw=None):
        """Saliency -> (grid, grid_y) at task/label resolution."""
        c = self.config
        solver = c.solver()
        xs_hm = pad_saliency(xs, solver.pad_x, solver.pad_y, c.pad_mode)
        task_hw = tuple(task_hw) if task_hw is not None else c.task_hw
        if label_hw is None:
            label_hw = (task_hw[0] // c.segm_downsampling_rate,
                        task_hw[1] // c.segm_downsampling_rate)
        return solver.create_grid(xs_hm, task_hw, label_hw)

    def _warp(self, x: torch.Tensor, grid: torch.Tensor, task_hw) -> torch.Tensor:
        """Forward warp in the compute dtype -> x_sampled NHWC. The image is
        cast before the warp, as the JAX module casts it, so a bf16 warp
        rounds where the JAX package's does. The uniform-'BI' baseline
        bypasses the warp with a plain bilinear resize to ``task_hw``."""
        if self.config.uniform_sample == "BI":
            return resize_bilinear(x.to(self.dtype), task_hw)
        return grid_sample(x.to(self.dtype), grid)

    def _segment(self, x_sampled: torch.Tensor) -> torch.Tensor:
        """Encoder/decoder of the warped image -> pred NHWC; row-partitioned
        when a spatial group is set (inference only: a training forward
        raises)."""
        x = x_sampled.permute(0, 3, 1, 2).contiguous()
        if self.spatial_rows is not None:
            from fovealseg_torch.parallel.spatial import run_trunk

            return run_trunk(self.encoder, self.decoder, x, self.spatial_rows).permute(0, 2, 3, 1)
        return self.decoder(self.encoder(x)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, focus_point: torch.Tensor, train: bool = False,
                xs_override=None, y=None, pool_s=None, rng: torch.Generator | None = None,
                grad: bool | None = None):
        """Warped-domain forward: dict(xs, xs_our, grid, grid_y, x_sampled,
        pred), plus ``pred_hr`` [B, H/r, W/r, C] f32 under
        ``MODEL.loss_at_high_res``.

        ``train`` runs the sub-networks in train mode (BN on batch statistics,
        updating the running ones; dropout drawn from ``rng``, a
        ``torch.Generator`` on the model's device) for the call. ``grad``
        (default: ``train``) records gradients: the ``TRAIN.fix_bn`` step
        passes ``train=False, grad=True``. ``y`` [B, H, W] feeds
        ``MODEL.gt_gradient``; ``xs_override`` [B, gh, gw, 1] replaces the
        saliency (detached); ``pool_s`` (a host int, or None) applies the
        Recasens pretrain pool when >= 0. ``xs_our`` is the saliency before
        the overrides, through which the norm edge loss trains the saliency
        nets."""
        c = self.config
        grad = train if grad is None else grad
        with self._mode(train), torch.set_grad_enabled(grad), dropout_generator(rng):
            xs_our = self.saliency(x, focus_point, train=train)
            xs = self._apply_overrides(xs_our, y, xs_override)
            grid, grid_y = self.grids(xs)
            x_sampled = self._warp(x, grid, c.task_hw)
            if pool_s is not None and int(pool_s) >= 0:
                # gated on pool_s alone, not on train: the reference pools in
                # the TRAIN.fix_bn (eval-mode) training forward too
                x_sampled = pretrain_pool(x_sampled, pool_s, c.saliency_hw)
            pred = self._segment(x_sampled)
            out = dict(xs=xs, xs_our=xs_our, grid=grid, grid_y=grid_y,
                       x_sampled=x_sampled, pred=pred)
            if c.loss_at_high_res:
                out["pred_hr"] = self._pred_high_res(pred, grid, (x.shape[1], x.shape[2]))
        return out

    def _pred_high_res(self, pred: torch.Tensor, grid: torch.Tensor, hw) -> torch.Tensor:
        """``MODEL.loss_at_high_res``: the prediction at full resolution, as
        the JAX module makes it. The flood's indices come from the valid mask
        only, so the gradient reaches ``pred`` through the row gather (K5's
        backward) and the samples."""
        c = self.config
        pred32 = pred.to(torch.float32)
        if c.uniform_sample == "BI":
            return resize_bilinear(pred32, hw)
        seg_hw = (hw[0] // c.segm_downsampling_rate, hw[1] // c.segm_downsampling_rate)
        grid = grid.detach()
        task_idx, valid = inverse_grid_index(grid, seg_hw)
        jfa_iters = c.jfa_iters or None
        rounds = None if c.jfa_iters else jfa_rounds_from_grid(grid, seg_hw)
        if c.rev_deform_interp == "nearest":
            return unwarp_prediction_fast(pred32, task_idx, valid, jfa_iters, rounds)
        grid_inv = grid_from_index(task_idx, valid, (grid.shape[1], grid.shape[2]))
        return unwarp_prediction(pred32, grid_inv, valid, interp=c.rev_deform_interp)

    @torch.no_grad()
    def infer(self, x: torch.Tensor, focus_point: torch.Tensor, seg_hw=None, y=None,
              y_sampled_reverse: bool = False, x_sampled_reverse: bool = False,
              argmax_labels: bool = False):
        """Full-resolution inference with inverse warp and hole fill:
        dict(xs, grid, grid_y, grid_inv, unfilled_mask, x_sampled, pred) plus
        ``pred_sampled`` [B, Hs, Ws, C] f32 full-res scores (not on the argmax
        path with 'nearest'), ``pred_label`` [B, Hs, Ws] int32 when
        ``argmax_labels``, and the round trips when asked: ``y_sampled``
        [B, th, tw] and ``y_sampled_reverse`` [B, Hs, Ws] (f32 labels; needs
        ``y`` [B, Hs, Ws]), ``x_sampled_reverse`` [B, Hs, Ws, 3].
        x: [B, H, W, 3] in [0, 1]; focus_point: [B, 2]."""
        with self._mode(False):
            return self._infer(x, focus_point, seg_hw, y, y_sampled_reverse, x_sampled_reverse,
                               argmax_labels)

    def _infer(self, x, focus_point, seg_hw, y, y_sampled_reverse, x_sampled_reverse,
               argmax_labels):
        c = self.config
        seg_hw = tuple(seg_hw) if seg_hw is not None else (x.shape[1], x.shape[2])
        xs = self._apply_overrides(self.saliency(x, focus_point), y)
        grid, grid_y = self.grids(xs, task_hw=c.task_hw_infer, label_hw=c.task_hw_infer)
        x_sampled = self._warp(x, grid, c.task_hw_infer)
        pred = self._segment(x_sampled)
        task_idx, valid = inverse_grid_index(grid, seg_hw)
        grid_inv = grid_from_index(task_idx, valid, (grid.shape[1], grid.shape[2]))
        jfa_iters = c.jfa_iters or None
        rounds = None if c.jfa_iters else jfa_rounds_from_grid(grid, seg_hw)
        pred32 = pred.to(torch.float32)
        out = dict(xs=xs, grid=grid, grid_y=grid_y, grid_inv=grid_inv, unfilled_mask=~valid,
                   x_sampled=x_sampled, pred=pred)
        if c.uniform_sample in ("BI", "nearest"):
            # the uniform baselines invert the "warp" by a plain upsample
            resize = resize_bilinear if c.uniform_sample == "BI" else resize_nearest
            out["pred_sampled"] = resize(pred32, seg_hw)
            if argmax_labels:
                out["pred_label"] = torch.argmax(out["pred_sampled"], dim=-1).to(torch.int32)
        elif argmax_labels and c.rev_deform_interp == "nearest":
            # serving: argmax commutes with the row-gather inverse warp, so the
            # class ids ride the landing scatter and the class-mode flood
            out["pred_label"] = unwarp_argmax_scatter(pred32, grid, seg_hw, jfa_iters, rounds)
        elif c.rev_deform_interp == "nearest":
            out["pred_sampled"] = unwarp_prediction_fast(
                pred32, task_idx, valid, jfa_iters, rounds,
                gather_bf16=c.scoremap_gather_bf16, gather_impl=c.scoremap_gather)
        else:
            out["pred_sampled"] = unwarp_prediction(pred32, grid_inv, valid,
                                                    interp=c.rev_deform_interp)
            if argmax_labels:
                out["pred_label"] = torch.argmax(out["pred_sampled"], dim=-1).to(torch.int32)
        if y_sampled_reverse and y is not None and c.uniform_sample == "BI":
            # uniform 'BI': bilinear downsample truncated to ids, nearest upsample
            y_s = torch.floor(resize_bilinear(y.to(torch.float32)[..., None], c.task_hw_infer))
            out["y_sampled"] = y_s[..., 0]
            out["y_sampled_reverse"] = resize_nearest(y_s, seg_hw)[..., 0]
        elif y_sampled_reverse and y is not None:
            # the labels down through the forward grid and back up, branched on
            # rev_deform_interp as the JAX package does
            y_s = grid_sample(y.to(torch.float32)[..., None], grid_y, mode="nearest")
            out["y_sampled"] = y_s[..., 0]
            if c.rev_deform_interp == "nearest":
                rev = unwarp_labels_fast(y_s, task_idx, valid, jfa_iters, rounds)[..., 0]
            elif c.rev_deform_interp == "BI":
                # raw class ids value-filled at the holes (fractional there)
                grid_safe = torch.where(torch.isnan(grid_inv), 0.0, grid_inv)
                sampled = grid_sample(y_s, grid_safe, mode="nearest")
                sampled = sampled * valid[..., None].to(sampled.dtype)
                rev = fill_values_splat(sampled, valid)[..., 0]
            else:
                # 'tri': one-hot score planes, inverse warp, value fill, argmax;
                # labels outside [0, num_class) give an all-zero plane
                classes = torch.arange(c.num_class, device=y_s.device, dtype=torch.int32)
                scores = (y_s.to(torch.int32) == classes).to(torch.float32)
                rev = torch.argmax(unwarp_prediction(scores, grid_inv, valid,
                                                     interp=c.rev_deform_interp), dim=-1)
                rev = rev.to(torch.float32)
            out["y_sampled_reverse"] = rev
        if x_sampled_reverse and c.uniform_sample == "BI":
            out["x_sampled_reverse"] = resize_bilinear(x_sampled.to(torch.float32), seg_hw)
        elif x_sampled_reverse:
            out["x_sampled_reverse"] = unwarp_prediction(
                x_sampled.to(torch.float32), grid_inv, valid, interp=c.rev_deform_interp)
        return out
