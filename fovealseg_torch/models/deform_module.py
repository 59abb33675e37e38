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

This slice ports the eval forward and the argmax serving path of ``infer``
(``argmax_labels=True``, ``rev_deform_interp='nearest'``). Other branches
raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from fovealseg_torch import resolve_device
from fovealseg_torch.core.gaze import focus_distance_map
from fovealseg_torch.core.grid import GridSolver, inverse_grid_index, pad_saliency
from fovealseg_torch.core.interpolate import resize_bilinear, resize_bilinear_nchw
from fovealseg_torch.core.unwarp import jfa_rounds_from_grid, unwarp_argmax_scatter
from fovealseg_torch.core.warp import grid_sample_nchw


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    """Static geometry/config snapshot: the JAX package's DeformConfig fields
    this slice reads, with the same defaults (the score-map gather and
    gt-gradient sampler fields arrive with their slices)."""

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
    gt_gradient: bool = False
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
            gt_gradient=cfg.MODEL.gt_gradient,
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
    """Foveation + segmentation, eval forward and argmax serving.

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
        """Image + gaze -> softmax saliency map [B, gh, gw, 1] (eval)."""
        c = self.config
        if c.f_xlr_low_scale > 1:
            raise NotImplementedError(
                "VAL.F_Xlr_low_scale > 1 (low-scale saliency input) arrives with the eval slice")
        solver = c.solver()
        sal_hw = c.saliency_hw
        x_low = resize_bilinear(x, sal_hw)
        fm = focus_distance_map(focus_point, *sal_hw).to(x.dtype)
        x5 = torch.cat([x_low, fm, fm], dim=-1).permute(0, 3, 1, 2)
        xs = self.net_compress(self.localization(x5))
        xs = resize_bilinear_nchw(xs, (solver.grid_h, solver.grid_w))
        b = xs.shape[0]
        flat = xs.reshape(b, -1).to(torch.float32)
        return torch.softmax(flat, dim=-1).reshape(b, solver.grid_h, solver.grid_w, 1)

    def _apply_overrides(self, xs: torch.Tensor, y=None, xs_override=None) -> torch.Tensor:
        """The saliency overrides of the JAX module, default path only."""
        c = self.config
        if xs_override is not None or c.gt_gradient:
            raise NotImplementedError(
                "saliency overrides (xs_override, MODEL.gt_gradient) arrive with the training slice")
        if c.uniform_sample != "":
            raise NotImplementedError(
                "MODEL.uniform_sample baselines arrive with the eval slice")
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

    def _segment(self, x: torch.Tensor, grid: torch.Tensor):
        """Forward warp + encoder/decoder -> (x_sampled NHWC, pred NHWC f32)."""
        x_sampled = grid_sample_nchw(x.permute(0, 3, 1, 2), grid).to(self.dtype)
        pred = self.decoder(self.encoder(x_sampled))
        return x_sampled.permute(0, 2, 3, 1), pred.permute(0, 2, 3, 1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, focus_point: torch.Tensor, train: bool = False):
        """Warped-domain eval forward: dict(xs, xs_our, grid, grid_y,
        x_sampled, pred)."""
        if train or self.training:
            raise NotImplementedError("the training forward arrives with the training slice")
        if self.config.loss_at_high_res:
            raise NotImplementedError("MODEL.loss_at_high_res arrives with the training slice")
        xs_our = self.saliency(x, focus_point)
        xs = self._apply_overrides(xs_our)
        grid, grid_y = self.grids(xs)
        x_sampled, pred = self._segment(x, grid)
        return dict(xs=xs, xs_our=xs_our, grid=grid, grid_y=grid_y,
                    x_sampled=x_sampled, pred=pred)

    @torch.no_grad()
    def infer(self, x: torch.Tensor, focus_point: torch.Tensor, seg_hw=None, y=None,
              y_sampled_reverse: bool = False, x_sampled_reverse: bool = False,
              argmax_labels: bool = False):
        """Full-resolution argmax serving: dict(xs, grid, grid_y, grid_inv,
        unfilled_mask, x_sampled, pred, pred_label); ``pred_label`` is
        [B, Hs, Ws] int32. x: [B, H, W, 3] in [0, 1]; focus_point: [B, 2]."""
        c = self.config
        if not argmax_labels or c.rev_deform_interp != "nearest":
            raise NotImplementedError(
                "only infer(argmax_labels=True) with rev_deform_interp='nearest' is ported; the "
                "score-map and 'BI'/'tri' inverse warps arrive with the score-map slice")
        if y_sampled_reverse or x_sampled_reverse:
            raise NotImplementedError(
                "the y/x_sampled_reverse round trips arrive with the label inverse-warp slice")
        seg_hw = tuple(seg_hw) if seg_hw is not None else (x.shape[1], x.shape[2])
        xs = self._apply_overrides(self.saliency(x, focus_point), y)
        grid, grid_y = self.grids(xs, task_hw=c.task_hw_infer, label_hw=c.task_hw_infer)
        x_sampled, pred = self._segment(x, grid)
        task_idx, valid = inverse_grid_index(grid, seg_hw)
        th, tw = grid.shape[1], grid.shape[2]
        safe = torch.clamp(task_idx, min=0)
        gx = torch.where(valid, (safe % tw) / tw * 2.0 - 1.0, float("nan"))
        gy = torch.where(valid, torch.div(safe, tw, rounding_mode="floor") / th * 2.0 - 1.0,
                         float("nan"))
        grid_inv = torch.stack([gx, gy], dim=-1)
        rounds = None if c.jfa_iters else jfa_rounds_from_grid(grid, seg_hw)
        pred_label = unwarp_argmax_scatter(pred.to(torch.float32), grid, seg_hw,
                                           c.jfa_iters or None, rounds)
        return dict(xs=xs, grid=grid, grid_y=grid_y, grid_inv=grid_inv,
                    unfilled_mask=~valid, x_sampled=x_sampled, pred=pred,
                    pred_label=pred_label)
