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

The eval forward and ``infer`` are ported: argmax labels and full-res score
maps in every ``rev_deform_interp`` ('nearest', 'BI', 'tri'), the
``y_sampled_reverse`` / ``x_sampled_reverse`` round trips, the
``MODEL.uniform_sample`` baselines ('BI' bypasses the warp with a plain
bilinear resize, and both invert it with a plain resize),
``VAL.F_Xlr_low_scale > 1`` (a smaller saliency input at inference) and
``MODEL.gt_gradient`` (with labels, the label-edge sampler or the zero-bound
mask; without them the saliency passes through, as in the JAX package).
Training, ``xs_override``, ``MODEL.loss_at_high_res`` and
``TPU.scoremap_gather_bf16`` raise ``NotImplementedError`` naming where they
go. The module runs under ``no_grad``, so the JAX package's
``stop_gradient`` on an overridden saliency has nothing to stop here.
"""

from __future__ import annotations

import dataclasses

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
    scoremap_gather_bf16: bool = False  # TPU.scoremap_gather_bf16: not ported
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


class DeformSegmentation(nn.Module):
    """Foveation + segmentation, eval forward and full-resolution inference.

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
        self.to(self.device)
        self.eval()

    def saliency(self, x: torch.Tensor, focus_point: torch.Tensor) -> torch.Tensor:
        """Image + gaze -> softmax saliency map [B, gh, gw, 1] (eval).
        ``VAL.F_Xlr_low_scale > 1`` divides the saliency input size."""
        c = self.config
        solver = c.solver()
        sal_hw = c.saliency_hw
        if c.f_xlr_low_scale > 1:
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
        applies; then the ``MODEL.uniform_sample`` flattening."""
        c = self.config
        if xs_override is not None:
            raise NotImplementedError(
                "xs_override arrives with the training slice (ROADMAP queue 1, item 4)")
        if c.gt_gradient and y is not None:
            if c.fix_gt_gradient and not (c.uniform_sample == "BI" and c.num_class == 2):
                yy = y.to(torch.float32)
                for k in c.ignore_gt_labels:
                    yy = torch.where(yy == k, 0.0, yy)
                xs = edge_target_pil_style(
                    yy, c.saliency_hw, (xs.shape[1], xs.shape[2]), c.gt_grad_blur_r,
                    softmax=False, zero_bound=c.deform_zero_bound).to(xs.dtype)
            elif c.deform_zero_bound:
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

    def _segment(self, x: torch.Tensor, grid: torch.Tensor, task_hw):
        """Forward warp in the compute dtype + encoder/decoder -> (x_sampled
        NHWC, pred NHWC). The image is cast before the warp, as the JAX
        module casts it, so a bf16 warp rounds where the JAX package's does.
        The uniform-'BI' baseline bypasses the warp with a plain bilinear
        resize to ``task_hw``."""
        if self.config.uniform_sample == "BI":
            x_sampled = resize_bilinear(x.to(self.dtype), task_hw)
        else:
            x_sampled = grid_sample(x.to(self.dtype), grid)
        pred = self.decoder(self.encoder(x_sampled.permute(0, 3, 1, 2).contiguous()))
        return x_sampled, pred.permute(0, 2, 3, 1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, focus_point: torch.Tensor, train: bool = False,
                xs_override=None, y=None):
        """Warped-domain eval forward: dict(xs, xs_our, grid, grid_y,
        x_sampled, pred). ``y`` [B, H, W] feeds ``MODEL.gt_gradient``."""
        if train or self.training:
            raise NotImplementedError("the training forward arrives with the training slice")
        if self.config.loss_at_high_res:
            raise NotImplementedError("MODEL.loss_at_high_res arrives with the training slice")
        xs_our = self.saliency(x, focus_point)
        xs = self._apply_overrides(xs_our, y, xs_override)
        grid, grid_y = self.grids(xs)
        x_sampled, pred = self._segment(x, grid, self.config.task_hw)
        return dict(xs=xs, xs_our=xs_our, grid=grid, grid_y=grid_y,
                    x_sampled=x_sampled, pred=pred)

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
        c = self.config
        seg_hw = tuple(seg_hw) if seg_hw is not None else (x.shape[1], x.shape[2])
        xs = self._apply_overrides(self.saliency(x, focus_point), y)
        grid, grid_y = self.grids(xs, task_hw=c.task_hw_infer, label_hw=c.task_hw_infer)
        x_sampled, pred = self._segment(x, grid, c.task_hw_infer)
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
