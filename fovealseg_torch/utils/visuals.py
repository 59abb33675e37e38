"""PNG dumps of the eval visualisation (counterpart of
``fovealseg_tpu/utils/visuals.py``): the HSV class palette (the last class,
background, is black), class maps and [0, 1] images as PNG, and the
per-iteration dump set ``{tag}_{pred,gt,gt_hr,grid,sm,reddot}.png``, and the
training visual set of one batch (``collect_deform_visuals``,
``dump_batch_visuals``). PIL is imported inside each writer, so nothing here
needs it until a dump is asked for.
"""

from __future__ import annotations

import colorsys
import os

import numpy as np


def generate_colormap_colors(num_colors: int = 51) -> list[tuple[int, int, int]]:
    """HSV wheel palette; the last class (background) is black."""
    colors = []
    for i in range(num_colors):
        r, g, b = colorsys.hsv_to_rgb(i / num_colors, 1.0, 1.0)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    colors[-1] = (0, 0, 0)
    return colors


def rgb_img(class_map: np.ndarray, num_classes: int = 51):
    """Integer class map [H, W] -> PIL RGB image with the HSV palette."""
    from PIL import Image

    palette = np.asarray(generate_colormap_colors(num_classes), dtype=np.uint8)
    cm = np.clip(np.asarray(class_map, dtype=np.int64), 0, num_classes - 1)
    return Image.fromarray(palette[cm])


def save_gray(img01: np.ndarray, path: str) -> None:
    """[H, W] floats in [0, 1] -> grayscale PNG."""
    from PIL import Image

    arr = np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr, "L").save(path)


def save_rgb01(img01: np.ndarray, path: str) -> None:
    """[H, W, 3] floats in [0, 1] -> PNG."""
    from PIL import Image

    arr = np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def make_grid_pattern(h: int, w: int, spacing: int = 16) -> np.ndarray:
    """A line-grid image [H, W, 3] in [0, 1]; warped through the sampling grid
    it shows the sampling density."""
    img = np.ones((h, w, 3), dtype=np.float32)
    img[::spacing, :, :] = 0.0
    img[:, ::spacing, :] = 0.0
    return img


def red_dot_overlay(image01: np.ndarray, sample_mask: np.ndarray) -> np.ndarray:
    """The image with the sampled full-res pixels (``sample_mask``, dilated
    once in 4-connectivity) painted red."""
    m = np.asarray(sample_mask, dtype=bool)
    d = m.copy()
    d[1:, :] |= m[:-1, :]
    d[:-1, :] |= m[1:, :]
    d[:, 1:] |= m[:, :-1]
    d[:, :-1] |= m[:, 1:]
    out = np.asarray(image01, dtype=np.float32).copy()
    out[d] = np.asarray([1.0, 0.0, 0.0], dtype=np.float32)
    return out


def dump_train_visuals(save_dir: str, tag: str, *, pred_logits=None, gt=None, gt_hr=None,
                       saliency=None, grid_image=None, sample_mask=None, image=None,
                       num_classes: int = 51) -> list[str]:
    """Write ``{tag}_{pred,gt,gt_hr,sm,grid,reddot}.png`` for the arrays
    given (``reddot`` needs ``image`` and ``sample_mask``); returns the
    written paths."""
    os.makedirs(save_dir, exist_ok=True)
    written = []

    def p(name):
        path = os.path.join(save_dir, f"{tag}_{name}.png")
        written.append(path)
        return path

    if pred_logits is not None:
        rgb_img(np.argmax(pred_logits, axis=-1), num_classes).save(p("pred"))
    if gt is not None:
        rgb_img(gt, num_classes).save(p("gt"))
    if gt_hr is not None:
        rgb_img(gt_hr, num_classes).save(p("gt_hr"))
    if saliency is not None:
        s = np.asarray(saliency, dtype=np.float32)
        save_gray(s / (s.max() + 1e-12), p("sm"))
    if grid_image is not None:
        save_rgb01(grid_image, p("grid"))
    if image is not None and sample_mask is not None:
        save_rgb01(red_dot_overlay(image, sample_mask), p("reddot"))
    return written


def collect_deform_visuals(model, batch: dict, num_classes: int = 51) -> dict:
    """The eval forward of ``model`` on one batch (tensors on its device), as
    numpy arrays: pred [B,h,w,C] logits, gt [B,h,w] warped ground truth,
    gt_hr [B,H,W], sm [B,gh,gw] saliency, grid_image [B,h,w,3] (a line grid
    warped through the sampling grid), sample_mask [B,H,W] (where a task
    pixel landed), image [B,H,W,3]."""
    import torch

    from fovealseg_torch.core.grid import inverse_grid_index
    from fovealseg_torch.core.warp import grid_sample

    x, f = batch["img_data"], batch["focus_point"]
    y = batch["seg_label"].to(torch.float32)
    cls = batch["cls_label"].reshape(-1).to(torch.int64)
    bg = num_classes - 1
    with torch.no_grad():
        out = model(x, f, train=False)
        grid = out["grid"]
        h, w = x.shape[1], x.shape[2]
        pattern = torch.from_numpy(make_grid_pattern(h, w)).to(x.device)
        grid_image = grid_sample(pattern[None].expand(x.shape[0], h, w, 3).contiguous(), grid)
        _, valid = inverse_grid_index(grid, (h, w))
        y_s = grid_sample(y[..., None], out["grid_y"])[..., 0].to(torch.int64)
    gt = y_s * cls[:, None, None] + (1 - y_s) * bg
    yl = y.to(torch.int64)
    gt_hr = yl * cls[:, None, None] + (1 - yl) * bg
    return {"pred": out["pred"].float().cpu().numpy(), "gt": gt.cpu().numpy(),
            "gt_hr": gt_hr.cpu().numpy(), "sm": out["xs"][..., 0].float().cpu().numpy(),
            "grid_image": grid_image.float().cpu().numpy(), "sample_mask": valid.cpu().numpy(),
            "image": x.float().cpu().numpy()}


def dump_batch_visuals(save_dir: str, vis: dict, cur_iter: int = 0, num_classes: int = 51,
                       max_items: int | None = None) -> list[str]:
    """Dump ``collect_deform_visuals``' arrays for the first B/2 samples as
    ``iter{it}_batch{i}_*``."""
    b = vis["pred"].shape[0]
    n = max_items if max_items is not None else max(1, b // 2)
    written = []
    for i in range(min(n, b)):
        written += dump_train_visuals(
            save_dir, f"iter{cur_iter}_batch{i}", pred_logits=vis["pred"][i], gt=vis["gt"][i],
            gt_hr=vis["gt_hr"][i], saliency=vis["sm"][i], grid_image=vis["grid_image"][i],
            sample_mask=vis["sample_mask"][i], image=vis["image"][i], num_classes=num_classes)
    return written
