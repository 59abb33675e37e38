"""ADE20K class metadata and palettes (counterpart of ``fovealseg_tpu/utils/ade.py``).

* ``load_object_info(csv_path)`` reads an object-info csv of the reference's
  schema (Idx, Ratio, Train, Val, Stuff, Name) when it exists, else gives the
  built-in ADE20K table (150 classes) or generic ``class_{i}`` names.
* ``class_palette(150)`` is the ADE20K palette (the contents of the
  reference's ``data/color150.mat``, ``assets/ade20k.py``); any other class
  count takes the HSV wheel of
  :func:`fovealseg_torch.utils.visuals.generate_colormap_colors`.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def load_object_info(csv_path: str | None, num_class: int = 150) -> list[dict]:
    """Class metadata rows [{idx, name, ratio}]; synthesized when absent."""
    if csv_path and os.path.exists(csv_path):
        rows = []
        with open(csv_path) as f:
            for rec in csv.DictReader(f):
                rows.append({
                    "idx": int(rec.get("Idx", len(rows) + 1)),
                    "name": (rec.get("Name") or "").split(";")[0].strip(),
                    "ratio": float(rec.get("Ratio", 0.0) or 0.0),
                })
        if rows:
            return rows
    if num_class == 150:
        from fovealseg_torch.assets.ade20k import ADE20K_NAMES, ADE20K_RATIO

        return [
            {"idx": i + 1, "name": ADE20K_NAMES[i].split(";")[0].strip(),
             "ratio": ADE20K_RATIO[i]}
            for i in range(150)
        ]
    return [{"idx": i + 1, "name": f"class_{i}", "ratio": 0.0} for i in range(num_class)]


def class_names(csv_path: str | None, num_class: int = 150) -> list[str]:
    return [r["name"] for r in load_object_info(csv_path, num_class)]


def class_palette(num_class: int = 150) -> np.ndarray:
    """[num_class, 3] uint8 palette."""
    if num_class == 150:
        from fovealseg_torch.assets.ade20k import ade20k_colors

        return ade20k_colors()
    from fovealseg_torch.utils.visuals import generate_colormap_colors

    return np.asarray(generate_colormap_colors(num_class), dtype=np.uint8)


def color_encode(label_map: np.ndarray, num_class: int = 150) -> np.ndarray:
    """Integer label map -> RGB uint8 image (labels clipped to the palette)."""
    pal = class_palette(num_class)
    lm = np.clip(np.asarray(label_map, np.int64), 0, num_class - 1)
    return pal[lm]
