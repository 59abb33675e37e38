"""PNG dumps of the eval visualisation (counterpart of
``fovealseg_tpu/utils/visuals.py``): the HSV class palette (the last class,
background, is black), class maps and [0, 1] images as PNG, and the
per-iteration dump set ``{tag}_{pred,gt,gt_hr,sm}.png``. PIL is imported
inside each writer, so nothing here needs it until a dump is asked for.
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


def dump_train_visuals(save_dir: str, tag: str, *, pred_logits=None, gt=None, gt_hr=None,
                       saliency=None, num_classes: int = 51) -> list[str]:
    """Write ``{tag}_{pred,gt,gt_hr,sm}.png`` for the arrays given; returns
    the written paths."""
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
    return written
