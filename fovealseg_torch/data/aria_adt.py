"""Aria ADT (egocentric gaze) cache reader (counterpart of
``fovealseg_tpu/data/aria_adt.py``).

Cooked Aria frames carry their metadata in bracket-keyed file names
(``[fid]12_[ts]123x456_[cat]chair_[gz]100x200_[sp]3x480x640...``); a scan
of the cache writes one jsonl summary (``smry.json``) that the reader
indexes. Timestamp extraction from the VRS/mp4 recordings needs the
proprietary ``projectaria_tools`` and raises without it.

File name keys: fid frame index, ts timestamp, inm instance name, pnm
prototype name, cat category, iid instance id, cid category id, gz gaze
(row x col), sp tensor shape.
"""

from __future__ import annotations

import json
import os

import numpy as np

INT_KEYS = {"fid", "ts", "iid", "cid", "gz", "sp"}


def fname2info(fname: str) -> dict:
    """Parse a bracket-keyed cooked filename (b6_preprocess_aria_adt.py:28-46)."""
    body = fname
    for suf in (".pth.png", ".png", ".npy"):
        body = body.removesuffix(suf)
    info: dict = {}
    for sub in body.split("_"):
        if not sub.startswith("["):
            continue
        end = sub.find("]")
        if end < 0:
            continue
        key = sub[1:end]
        value = sub[end + 1 :]
        if key in INT_KEYS:
            info[key] = [int(v) for v in value.split("x")]
        else:
            info[key] = value
    return info


def info2fname(info: dict) -> str:
    parts = []
    for k, v in info.items():
        if isinstance(v, (list, tuple)):
            v = "x".join(str(int(x)) for x in v)
        parts.append(f"[{k}]{v}")
    return "_".join(parts)


def make_cache_summary(cache_dir: str, out_jsonl: str | None = None) -> list[dict]:
    """Scan a cooked Aria cache dir -> jsonl summary (the reference's
    ``smry.json``, b6:14)."""
    out_jsonl = out_jsonl or os.path.join(cache_dir, "smry.json")
    rows = []
    for name in sorted(os.listdir(cache_dir)):
        if not (name.endswith(".png") or name.endswith(".npy")):
            continue
        if name.endswith(".Y.npy") or name.endswith(".Y.pt"):
            # mask sidecars of a frame (read via fpath.replace('.png',
            # '.Y.npy') in DatasetAriaADT) — not samples themselves, and
            # their '.Y' tail breaks the [sp]HxW int parse
            continue
        info = fname2info(name)
        if not info:
            continue
        info["fpath"] = os.path.join(cache_dir, name)
        rows.append(info)
    with open(out_jsonl, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return rows


def extract_timestamps_us(mp4_path: str):
    """VRS/mp4 device timestamps; requires projectaria_tools (gated, as in
    aria_adt/extract_timestamp_us.py)."""
    try:
        from projectaria_tools.utils.vrs_to_mp4_utils import get_timestamp_from_mp4
    except ImportError as e:  # pragma: no cover - proprietary dependency
        raise ImportError(
            "projectaria_tools is required for Aria VRS timestamp extraction"
        ) from e
    return get_timestamp_from_mp4(mp4_path)


class DatasetAriaADT:
    """Runtime dataset over a summarized Aria cache: yields the standard
    (img_data, focus_point, seg_label, cls_label) contract."""

    def __init__(self, cache_dir: str, summary_jsonl: str | None = None):
        path = summary_jsonl or os.path.join(cache_dir, "smry.json")
        if not os.path.exists(path):
            make_cache_summary(cache_dir, path)
        with open(path) as f:
            self.rows = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        r = self.rows[idx]
        arr = np.asarray(Image.open(r["fpath"]).convert("RGB"), np.float32) / 255.0
        h, w = arr.shape[:2]
        gz = r.get("gz", [h // 2, w // 2])
        seg = np.zeros((h, w), np.float32)  # masks ship separately when cooked
        mask_path = r["fpath"].replace(".png", ".Y.npy")
        if os.path.exists(mask_path):
            seg = np.load(mask_path).astype(np.float32)
        return {
            "img_data": arr,
            "focus_point": np.asarray([gz[0] / h, gz[1] / w], np.float32),
            "seg_label": seg,
            "cls_label": np.int32(r.get("cid", [0])[0]),
        }
