"""Tiny dataset files for the port's tests, written from a seed (no JAX:
the card tests import this too)."""

import json

import numpy as np

from fovealseg_torch.data.lvis import CIDS_MONITORED, convert_index

# monitored ids whose training id fits the flagship's 51 classes (21 of the
# 49 map to 50 or above through ORIGINAL_IDX_TO_NEW_IDX)
TRAINABLE_CIDS = [c for c in CIDS_MONITORED if convert_index(c) < 50]


def lvis_json(path, seed=0, n_images=6, cids=TRAINABLE_CIDS):
    """An LVIS-format json: images up to 60x60 on a 64 canvas (one larger,
    which the cooker skips), polygons of the first 7 of ``cids`` (by default
    monitored ids that train at 51 classes; one polygon empty)."""
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(1, n_images + 1):
        h, w = (int(rng.integers(30, 61)), int(rng.integers(30, 61)))
        if i == n_images:
            h, w = 70, 50  # larger than the canvas: skipped
        images.append({"id": i, "height": h, "width": w})
        for k in range(3):
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            x1, y1 = rng.uniform(x0 + 4, w), rng.uniform(y0 + 4, h)
            poly = [x0, y0, x1, y0 + 1.5, x1 - 2.5, y1, x0 + 0.5, y1 - 1]
            if i == 2 and k == 0:
                poly = [1.0, 1.0, 1.2, 1.0, 1.1, 1.1]  # rasterizes to nothing
            anns.append({"id": 100 * i + k, "image_id": i,
                         "category_id": cids[(i * 3 + k) % min(7, len(cids))],
                         "segmentation": [[float(v) for v in poly]]})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return path
