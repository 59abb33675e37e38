"""Exact 'tri' hole fill (counterpart of ``fovealseg_tpu/native/interp2d.py``).

The reference fills the holes of an inverse-warped prediction by
Delaunay-triangulating the valid pixels that border a hole (plus the four
canvas corners) and blending each hole pixel from its triangle's three
corners with barycentric weights. Here the triangulation and point location
are host C++ (``spatial.cpp``) and give a per-sample *plan*, integer corners
and float weights over flat canvas indices; the sample through the inverse
grid and the 3-corner blend run in stock PyTorch on the prediction's device.

* :func:`build_interp_plan`, :func:`_border_valid_mask`,
  :func:`build_fill_plan`: the host plan;
* :func:`interp2d_dense` (the reference ``Interp2D``'s call shape, in numpy)
  and :func:`interp2d_apply` (the blend of a plan as a torch function of the
  values on their device, differentiable with respect to the values only,
  as ``Interp2D`` is);
* :func:`fill_missing_tri`, :func:`unwarp_prediction_tri`: the host oracle,
  per sample in numpy;
* :func:`unwarp_prediction_tri_device`: the production path of the eval CLI
  (``MODEL.rev_deform_interp='tri'`` with ``TPU.tri_exact``).
"""

from __future__ import annotations

import numpy as np
import torch

from fovealseg_torch.core.warp import grid_sample
from fovealseg_torch.native.spatial import Delaunay, nearest_neighbor


def build_interp_plan(points: np.ndarray, h: int, w: int):
    """points: [N, 2] (row, col) pixel coordinates. Returns (corner [h*w, 3]
    int32, weight [h*w, 3] float32) such that
    ``dense = (values[corner] * weight[..., None]).sum(1)``. Pixels outside
    the convex hull take their nearest point (weight 1)."""
    tri = Delaunay(points.astype(np.float64))
    ys, xs = np.mgrid[0:h, 0:w]
    q = np.stack([ys.ravel(), xs.ravel()], axis=-1).astype(np.float64)
    simplex, bary = tri.find_simplex(q, return_c=True)
    corner = np.zeros((h * w, 3), dtype=np.int32)
    weight = np.zeros((h * w, 3), dtype=np.float32)
    inside = simplex >= 0
    corner[inside] = tri.simplices[simplex[inside]]
    weight[inside] = bary[inside].astype(np.float32)
    if (~inside).any():
        corner[~inside, 0] = nearest_neighbor(points, q[~inside])
        weight[~inside, 0] = 1.0
    return corner, weight


def interp2d_dense(points: np.ndarray, values: np.ndarray, h: int, w: int) -> np.ndarray:
    """The reference ``Interp2D``'s call shape: points [N, 2] (row, col),
    values [N, C] -> dense [C, h, w] (channels first, as it returns)."""
    corner, weight = build_interp_plan(points, h, w)
    dense = (values[corner] * weight[..., None]).sum(axis=1)  # [h*w, C]
    return dense.T.reshape(values.shape[1], h, w)


def interp2d_apply(values: torch.Tensor, corner, weight) -> torch.Tensor:
    """The blend of a :func:`build_interp_plan` plan: values [N, C] ->
    [h*w, C], on the values' device. Gradients flow to ``values`` only; the
    plan is data."""
    corner = torch.as_tensor(np.asarray(corner), device=values.device).to(torch.int64)
    weight = torch.as_tensor(np.asarray(weight), device=values.device).to(values.dtype)
    return (values[corner] * weight[..., None]).sum(dim=1)


def _border_valid_mask(valid: np.ndarray) -> np.ndarray:
    """The pixels the fill interpolates from: valid pixels in the 3x3
    dilation of the invalid mask, plus the four corners."""
    inv = ~valid
    d = inv.copy()
    d[1:, :] |= inv[:-1, :]
    d[:-1, :] |= inv[1:, :]
    d[:, 1:] |= inv[:, :-1]
    d[:, :-1] |= inv[:, 1:]
    d[1:, 1:] |= inv[:-1, :-1]
    d[1:, :-1] |= inv[:-1, 1:]
    d[:-1, 1:] |= inv[1:, :-1]
    d[:-1, :-1] |= inv[1:, 1:]
    m = d & valid
    m[0, 0] = m[0, -1] = m[-1, 0] = m[-1, -1] = True
    return m


def fill_missing_tri(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host oracle of the fill: values [H, W, C] (anything at invalid
    pixels), valid [H, W] bool -> values with the holes filled by barycentric
    interpolation; valid pixels are untouched, and an invalid corner
    contributes the value 0, as in the reference."""
    h, w, c = values.shape
    if valid.all():
        return values
    m = _border_valid_mask(valid)
    vals = values.copy()
    for cy, cx in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)):
        if not valid[cy, cx]:
            vals[cy, cx] = 0.0
    pts = np.argwhere(m).astype(np.float64)
    pvals = vals[m]
    corner, weight = build_interp_plan(pts, h, w)
    dense = (pvals[corner] * weight[..., None]).sum(axis=1).reshape(h, w, c)
    out = values.copy()
    out[~valid] = dense[~valid]
    return out


def build_fill_plan(valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Whole-canvas fill plan over flat canvas indices: valid [H, W] bool ->
    (corner [H*W, 3] int32, weight [H*W, 3] float32) such that, for
    ``v = sampled * valid`` flattened to [H*W, C],
    ``(v[corner] * weight[..., None]).sum(1)`` equals :func:`fill_missing_tri`
    at the holes and is the identity at valid pixels (own index, weight
    (1, 0, 0)). An invalid corner reads the masked value 0."""
    h, w = valid.shape
    flat = np.arange(h * w, dtype=np.int32)
    corner = np.zeros((h * w, 3), dtype=np.int32)
    weight = np.zeros((h * w, 3), dtype=np.float32)
    corner[:, 0] = flat
    weight[:, 0] = 1.0
    if valid.all():
        return corner, weight
    m = _border_valid_mask(valid)
    pts = np.argwhere(m).astype(np.float64)
    flat_pts = (pts[:, 0] * w + pts[:, 1]).astype(np.int32)
    c_local, wgt = build_interp_plan(pts, h, w)
    inv = ~valid.ravel()
    corner[inv] = flat_pts[c_local[inv]]
    weight[inv] = wgt[inv]
    return corner, weight


def _sample_valid(pred: torch.Tensor, grid_inv: torch.Tensor, valid: torch.Tensor):
    """Bilinear sample of pred [B, h, w, C] through grid_inv (NaN at holes),
    zero at the holes."""
    safe = torch.where(torch.isnan(grid_inv), 0.0, grid_inv)
    sampled = grid_sample(pred.to(torch.float32), safe)
    return sampled * valid[..., None].to(sampled.dtype)


def unwarp_prediction_tri_device(pred: torch.Tensor, grid_inv: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """Production 'tri' inverse warp: pred [B, h, w, C], grid_inv
    [B, Hs, Ws, 2] (NaN at holes), valid [B, Hs, Ws] -> [B, Hs, Ws, C] f32 on
    pred's device. The plans are built on the host; the sample and the
    3-corner blend (one batched gather, the three terms summed in order) run
    on the device."""
    sampled = _sample_valid(pred, grid_inv, valid)
    b, hs, ws, c = sampled.shape
    plans = [build_fill_plan(v) for v in valid.cpu().numpy()]
    corner = torch.from_numpy(np.stack([p[0] for p in plans])).to(sampled.device, torch.int64)
    wgt = torch.from_numpy(np.stack([p[1] for p in plans])).to(sampled.device)[..., None]
    off = torch.arange(b, device=sampled.device).view(b, 1, 1) * (hs * ws)
    g = sampled.reshape(b * hs * ws, c)[(corner + off).reshape(-1)].reshape(b, hs * ws, 3, c)
    out = g[:, :, 0] * wgt[:, :, 0] + g[:, :, 1] * wgt[:, :, 1] + g[:, :, 2] * wgt[:, :, 2]
    return out.reshape(b, hs, ws, c)


def unwarp_prediction_tri(pred, grid_inv, valid) -> np.ndarray:
    """Host oracle of the 'tri' inverse warp: the same sample, then
    :func:`fill_missing_tri` per sample in numpy. Returns [B, Hs, Ws, C]."""
    sampled = _sample_valid(torch.as_tensor(pred).cpu(), torch.as_tensor(grid_inv).cpu(),
                            torch.as_tensor(valid).cpu()).numpy()
    va = torch.as_tensor(valid).cpu().numpy()
    out = np.empty_like(sampled)
    for b in range(sampled.shape[0]):
        out[b] = fill_missing_tri(sampled[b], va[b])
    return out
