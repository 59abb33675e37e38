"""Synthetic LVIS-shaped data (counterpart of ``make_batch`` in
``fovealseg_tpu/data/synthetic.py``).

A batch follows the cooked-dataset contract: an RGB image on a
(canvas x canvas) canvas in [0, 1], one random ellipse instance brightened by
0.3, a gaze point strictly inside it normalised by the canvas size, the
binary instance mask, and a foreground class id in [0, num_fg_class). It is
numpy, and bit-equal to the JAX package's for the same generator state, so
the two eval CLIs see the same frames.
"""

from __future__ import annotations

import numpy as np


def make_batch(
    rng: np.random.Generator,
    batch: int = 2,
    canvas: int = 640,
    num_fg_class: int = 50,
) -> dict:
    """Returns dict(img_data [B,H,W,3], focus_point [B,2], seg_label [B,H,W],
    cls_label [B]) as float32/int32 numpy arrays (NHWC)."""
    imgs = rng.random((batch, canvas, canvas, 3), dtype=np.float32)
    cls = rng.integers(0, num_fg_class, (batch,)).astype(np.int32)
    c = rng.integers(canvas // 4, 3 * canvas // 4, (batch, 2)).astype(np.float32)
    r = rng.integers(canvas // 16, canvas // 6, (batch, 2)).astype(np.float32)

    yy = np.arange(canvas, dtype=np.float32)[None, :, None]
    xx = np.arange(canvas, dtype=np.float32)[None, None, :]
    cy, cx = c[:, 0, None, None], c[:, 1, None, None]
    ry, rx = r[:, 0, None, None], r[:, 1, None, None]
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    masks = inside.astype(np.float32)
    # the instance covers a few % of the canvas: a sparse update is much
    # cheaper than a broadcast over every pixel
    imgs[inside] = np.clip(imgs[inside] + 0.3, 0.0, 1.0)

    # a uniform point inside the ellipse (polar sqrt sampling), the radius
    # shrunk so that rounding to the pixel grid cannot push it outside
    t = rng.random(batch)
    a = rng.random(batch) * 2.0 * np.pi
    s = np.sqrt(t) * np.maximum(1.0 - 1.5 / r.min(axis=1), 0.0)
    fy = np.rint(c[:, 0] + s * r[:, 0] * np.cos(a))
    fx = np.rint(c[:, 1] + s * r[:, 1] * np.sin(a))
    focus = np.stack([fy, fx], axis=1).astype(np.float32) / canvas

    return {
        "img_data": imgs,
        "focus_point": focus,
        "seg_label": masks,
        "cls_label": cls,
    }
