"""Cityscapes cookers and readers (counterpart of ``fovealseg_tpu/data/cityscapes.py``).

* The gaze-crop cooker ``PreprocessCityscapes`` walks the gtFine polygon
  jsons, rasterizes one polygon instance per sample, picks a gaze pixel
  where the instance is visible, crops a window around it, and writes the
  mask and the frame as ``.npy`` with the metadata in the name
  (``{label}_c{idx}_k{idx}_{itemkey}_{gy}x{gx}_1xHxW.uint8.Y.npy``);
  ``DatasetCityscapes`` reads them back as (X, F, Y_seg, Y_cls), as the
  LVIS reader does.
* The RGB-label cooker ``PreprocessCityscapesRGBLabel`` centre-crops a frame
  and its colour label render, decodes the colours to 20 class ids
  (``decode_rgb_label``), and writes X/Y pairs; ``DatasetCityscapesRGBLabel``
  reads them back.

The draws, their order and the names are the JAX package's, so the cooked
trees are byte-equal. ``data/loader.py::CachedDataset`` keeps a reader's
items in RAM.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass

import numpy as np

from fovealseg_torch.data.lvis import rank_block, rasterize_polygon, stack


def wrap_name(name: str) -> str:
    """Spaces -> dashes (b3_preprocess_cityscapes.py:45-46)."""
    return name.replace(" ", "-")


def _stable_seed(key: str) -> int:
    """Process-independent seed for synthetic fallbacks (built-in hash() is
    PYTHONHASHSEED-randomized, which would make 'deterministic' synthetic
    frames differ across runs)."""
    import zlib

    return zlib.crc32(key.encode())


# b3 get_labels_ordered (b3_preprocess_cityscapes.py:194-265): the 41-entry
# priority-ordered label list (most important first; index 40 = unlabeled).
IDX2LABEL = [wrap_name(n) for n in [
    "person", "persongroup",
    "rider", "ridergroup",
    "bicycle", "bicyclegroup",
    "motorcycle", "motorcyclegroup",
    "car", "cargroup",
    "truck", "truckgroup",
    "bus", "train",
    "caravan", "trailer",
    "license plate",
    "traffic light", "traffic sign",
    "pole", "polegroup",
    "bridge", "fence", "guard rail", "tunnel", "building", "wall",
    "rail track", "sidewalk", "parking", "road",
    "vegetation", "terrain", "ground",
    "dynamic", "static", "ego vehicle", "sky",
    "out of roi", "rectification border",
    "unlabeled",
]]
LABEL2IDX = {label: idx for idx, label in enumerate(IDX2LABEL)}

# b3:527-549 — label2idx index -> contiguous 19-class training id (unknown -> 0)
ORIGINAL_IDX_TO_NEW_IDX = {
    6: 0, 2: 1, 17: 2, 12: 3, 13: 4, 10: 5, 4: 6, 18: 7, 26: 8, 22: 9,
    32: 10, 0: 11, 19: 12, 37: 13, 28: 14, 8: 15, 31: 16, 25: 17, 30: 18,
}


def convert_index(original_index: int) -> int:
    return ORIGINAL_IDX_TO_NEW_IDX.get(original_index, 0)


# b3 make_N_samples round-robin target classes (b3:476-496)
MAKE_SAMPLE_LABELS = [wrap_name(n) for n in [
    "motorcycle", "rider", "traffic light", "bus", "train", "truck",
    "bicycle", "traffic sign", "wall", "fence", "terrain", "person", "pole",
    "sky", "sidewalk", "car", "vegetation", "building", "road",
]]

# kept for callers that want the standard 19-class convention by name
CITYSCAPES_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]
NAME_TO_ID = {n: i for i, n in enumerate(CITYSCAPES_CLASSES)}


def polygon_mask(polygon, canvas_h: int, canvas_w: int) -> np.ndarray:
    """bool [H, W] raster of a cityscapes [x, y] polygon with the reference's
    negative-vertex wrap + clip preprocessing (get_rrcc_by_polygon, b3:33-42)."""
    p = np.array(polygon, dtype=np.float64)
    ys, xs = p[:, 1].copy(), p[:, 0].copy()
    ys[ys < 0] += canvas_h
    xs[xs < 0] += canvas_w
    ys = np.clip(ys, 0, canvas_h - 1)
    xs = np.clip(xs, 0, canvas_w - 1)
    return rasterize_polygon(np.stack([xs, ys], axis=-1), canvas_h, canvas_w)


def object_index_map(objs, canvas_h: int, canvas_w: int):
    """Occlusion-resolving object-index map (cache_oidxHxW, b3:81-144).

    Paints polygons back-to-front (the list is ordered most-important-first,
    so obj 0 is painted last and wins overlaps). Returns (oidx_map int32 with
    ``len(objs)`` as the no-object sentinel, sorted list of visible ids
    including the sentinel — mirroring the reference's uniques which include
    its 2^bits-1 default)."""
    n = len(objs)
    oidx_map = np.full((canvas_h, canvas_w), n, dtype=np.int32)
    for back, obj in enumerate(objs[::-1]):
        m = polygon_mask(obj["polygon"], canvas_h, canvas_w)
        oidx_map[m] = n - 1 - back
    visible = np.unique(oidx_map).tolist()
    return oidx_map, visible


def point_in_polygon(polygon, point) -> bool:
    """Ray-cast point-in-polygon ((x, y) vertex pairs; boundary-exclusive,
    matching shapely ``Polygon.contains`` used at b3:54)."""
    x, y = float(point[0]), float(point[1])
    p = np.asarray(polygon, np.float64)
    inside = False
    j = len(p) - 1
    for i in range(len(p)):
        xi, yi = p[i]
        xj, yj = p[j]
        if (yi > y) != (yj > y):
            t = (y - yi) / (yj - yi)
            if x < xi + t * (xj - xi):
                inside = not inside
        j = i
    return inside


def find_polygon(objs, point):
    """Which object contains the gaze point, preferring the most important
    label class (find_polygon, b3:49-66). Returns (label, polygon, idx) or
    ("", [], -1)."""
    labelidx2idxs: list[list[int]] = [[] for _ in IDX2LABEL]
    for idx, obj in enumerate(objs):
        label = wrap_name(obj["label"])
        if label not in LABEL2IDX:
            continue
        if point_in_polygon(obj["polygon"], point):
            labelidx2idxs[LABEL2IDX[label]].append(idx)
    for idxs in labelidx2idxs:
        if idxs:
            tidx = idxs[0]
            obj = objs[tidx]
            return wrap_name(obj["label"]), obj["polygon"], tidx
    return "", [], -1


@dataclass
class PreprocessCityscapes:
    """Offline cooker over gtFine polygon jsons (b3 PreprocessCityscapes,
    b3_preprocess_cityscapes.py:147-500).

    Semantics per the reference: full-resolution ``canvas_hw`` frames; a
    sample is built for a *target object* at a *gaze pixel* where it is
    visible (object-index map resolves occlusion); the crop window of size
    ``crop_hw`` is placed uniformly at random among windows containing the
    gaze (clamped to the canvas, b3:362-381); the label is the full raster of
    the target polygon (not visibility-masked, b3:355-360) cropped to the
    window; metadata rides in the filename
    ``{label}_c{idx}_k{idx}_{itemkey}_{gy}x{gx}_1x{H}x{W}.uint8.Y.npy``
    (b3:406-410; .npy replaces torch .pt)."""

    gtfine_dir: str  # gtFine/<split> containing <city>/*_gtFine_polygons.json
    out_dir: str
    image_dir: str | None = None  # leftImg8bit/<split>; synthetic X if absent
    canvas_hw: tuple = (1024, 2048)
    crop_hw: tuple = (512, 1024)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.items: list[tuple[str, str]] = []  # (itemkey, polygons path)
        for root, _, files in os.walk(self.gtfine_dir):
            for name in sorted(files):
                if name.endswith("_gtFine_polygons.json"):
                    key = name.replace("_gtFine_polygons.json", "")
                    self.items.append((key, os.path.join(root, name)))
        self._paths = dict(self.items)
        self._objs_cache: dict[str, list] = {}
        self._oidx_cache: dict[str, tuple] = {}
        self._frame_index: dict[str, str] | None = None  # built on first use

    def get_objs_ordered(self, itemkey: str) -> list:
        """Objects sorted by (label priority, polygon size) — "important &
        small object at front" (b3:313-323).  ``object_index_map`` paints
        back-to-front, so this order decides who wins occluded pixels;
        labels outside the 41-entry table sort last."""
        if itemkey not in self._objs_cache:
            with open(self._paths[itemkey]) as f:
                objs = json.load(f).get("objects", [])
            objs.sort(key=lambda obj: (
                LABEL2IDX.get(wrap_name(obj["label"]), len(IDX2LABEL)),
                len(obj["polygon"]),
            ))
            self._objs_cache[itemkey] = objs
        return self._objs_cache[itemkey]

    def _oidx_map(self, itemkey: str):
        if itemkey not in self._oidx_cache:
            self._oidx_cache[itemkey] = object_index_map(
                self.get_objs_ordered(itemkey), *self.canvas_hw
            )
        return self._oidx_cache[itemkey]

    def rank_itemkeys(self) -> list[str]:
        """Itemkeys by (distinct labels, object count) descending (b3:424-438)."""
        ranked = []
        for itemkey, _ in self.items:
            objs = self.get_objs_ordered(itemkey)
            ranked.append((len({o["label"] for o in objs}), len(objs), itemkey))
        ranked.sort(key=lambda t: (t[0], t[1]), reverse=True)
        return [t[2] for t in ranked]

    def _load_frame(self, itemkey: str) -> np.ndarray:
        """uint8 [H, W, 3] leftImg8bit frame (synthetic texture if absent)."""
        if self.image_dir:
            if self._frame_index is None:
                self._frame_index = {}
                for root, _, files in os.walk(self.image_dir):
                    for f in files:
                        if f.endswith("_leftImg8bit.png"):
                            self._frame_index[f.split("_leftImg8bit")[0]] = (
                                os.path.join(root, f)
                            )
            path = self._frame_index.get(itemkey)
            if path:
                from PIL import Image

                im = Image.open(path).convert("RGB")
                im = im.resize((self.canvas_hw[1], self.canvas_hw[0]))
                return np.asarray(im, np.uint8)
        rng = np.random.default_rng(_stable_seed(itemkey))
        return rng.integers(0, 256, (*self.canvas_hw, 3), dtype=np.uint8)

    def make_a_sample(self, itemkey: str, idx_h: int, idx_w: int,
                      oidx_target: int, mark: str = "default") -> str:
        objs = self.get_objs_ordered(itemkey)
        obj = objs[oidx_target]
        label = wrap_name(obj["label"])
        labelidx = LABEL2IDX[label]
        ch, cw = self.crop_hw
        hmax, wmax = self.canvas_hw
        mask = polygon_mask(obj["polygon"], hmax, wmax)
        # crop window uniformly among those containing the gaze, clamped
        hs = idx_h + self._rng.randint(-(ch - 1), 0)
        ws = idx_w + self._rng.randint(-(cw - 1), 0)
        hs = min(max(hs, 0), hmax - ch)
        ws = min(max(ws, 0), wmax - cw)
        gy, gx = idx_h - hs, idx_w - ws
        y = mask[hs:hs + ch, ws:ws + cw].astype(np.uint8)
        x = self._load_frame(itemkey)[hs:hs + ch, ws:ws + cw]
        out = os.path.join(self.out_dir, mark)
        os.makedirs(out, exist_ok=True)
        stem = (f"{label}_c{labelidx}_k{labelidx}_{itemkey.replace('_', '-')}_"
                f"{gy}x{gx}")
        np.save(os.path.join(out, f"{stem}_1x{ch}x{cw}.uint8.Y.npy"), y)
        np.save(os.path.join(out, f"{stem}_3x{ch}x{cw}.uint8.X.npy"), x)
        return stem

    def make_a_sample_by_label(self, label_target: str,
                               mark: str = "default") -> str | None:
        """Pick a random frame containing the class, a random *visible* pixel
        of a random instance as gaze, then cook (b3:440-474)."""
        label_target = wrap_name(label_target)
        candidates = [
            k for k, _ in self.items
            if any(wrap_name(o["label"]) == label_target
                   for o in self.get_objs_ordered(k))
        ]
        if not candidates:
            return None
        itemkey = self._rng.choice(candidates)
        objs = self.get_objs_ordered(itemkey)
        oidx_map, _ = self._oidx_map(itemkey)
        oidxs_valid = [i for i, o in enumerate(objs)
                       if wrap_name(o["label"]) == label_target]
        self._rng.shuffle(oidxs_valid)
        for oidx in oidxs_valid:
            pix = np.argwhere(oidx_map == oidx)
            if len(pix):
                idx_h, idx_w = pix[self._rng.randrange(len(pix))].tolist()
                return self.make_a_sample(itemkey, idx_h, idx_w, oidx, mark)
        return None

    def make_N_samples(self, n: int, marker: str = "default") -> list[str]:
        """Round-robin the 19 target classes (b3:475-500)."""
        written = []
        for i in range(n):
            stem = self.make_a_sample_by_label(
                MAKE_SAMPLE_LABELS[i % len(MAKE_SAMPLE_LABELS)], mark=marker
            )
            if stem is not None:
                written.append(stem)
        return written

    def cook(self, max_samples: int = -1, marker: str = "default") -> list[str]:
        """Convenience driver: one sample per (frame, known-label object)
        with the gaze at a random visible pixel of the object."""
        written = []
        for itemkey, _ in self.items:
            objs = self.get_objs_ordered(itemkey)
            oidx_map, _ = self._oidx_map(itemkey)
            for oidx, obj in enumerate(objs):
                if wrap_name(obj["label"]) not in LABEL2IDX:
                    continue
                pix = np.argwhere(oidx_map == oidx)
                if not len(pix):
                    continue
                idx_h, idx_w = pix[self._rng.randrange(len(pix))].tolist()
                written.append(self.make_a_sample(itemkey, idx_h, idx_w, oidx, marker))
                if 0 < max_samples <= len(written):
                    return written
        return written


class DatasetCityscapes:
    """Runtime dataset over cooked b3 samples (DatasetCityScapes, b3:531-598):
    parses the filename grammar, returns X [H, W, 3] float32 in [0, 1],
    focus point (gy/H, gx/W), the binary instance mask, and the 19-class
    training id via ``convert_index``. The reference's multiprocessing
    shared-memory twin (b3 ``_Parallel``:599-700) is covered by
    ``data/loader.py::CachedDataset``."""

    def __init__(self, cook_dir: str, marker: str = "default"):
        base = os.path.join(cook_dir, marker)
        self.dir = base if os.path.isdir(base) else cook_dir
        self.names = sorted(
            n for n in os.listdir(self.dir) if n.endswith(".Y.npy")
        )

    def __len__(self):
        return len(self.names)

    def class_ids(self) -> list[int]:
        """Each sample's training id, from the file names (no file read)."""
        return [convert_index(int(n.split(".")[0].split("_")[2][1:])) for n in self.names]

    def __getitem__(self, idx: int) -> dict:
        fname_y = self.names[idx]
        caty, cid, kid, itemkey, fpos, ihw = fname_y.split(".")[0].split("_")
        fname_x = f"{caty}_{cid}_{kid}_{itemkey}_{fpos}_3x{ihw[2:]}.uint8.X.npy"
        y = np.load(os.path.join(self.dir, fname_y)).astype(np.float32)
        xp = os.path.join(self.dir, fname_x)
        if os.path.exists(xp):
            x = np.load(xp).astype(np.float32) / 255.0
        else:
            rng = np.random.default_rng(_stable_seed(itemkey))
            x = rng.uniform(0, 1, (*y.shape, 3)).astype(np.float32)
        gy, gx = map(int, fpos.split("x"))
        h, w = y.shape
        return {
            "img_data": x,
            "focus_point": np.asarray([gy / h, gx / w], np.float32),
            "seg_label": y,
            "cls_label": np.int32(convert_index(int(kid[1:]))),
        }

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                rank: int = 0, world: int = 1):
        """Global batches in the JAX reader's order, each cut to rank
        ``rank``'s contiguous block (``lvis.py::rank_block``)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield stack([self[int(j)] for j in rank_block(order[i : i + batch_size], rank, world)])


# ---------------------------------------------------------------------------
# b4/b5 "rgblabel" variant: decode the color-rendered gtFine label PNG into a
# 20-class id mask (b4_preprocess_cityscapes_rgblabel.py:48-70 labels_valid;
# b5_preprocess_cityscapes_rgblabel_mask.py:191-236 make_a_sample).
# Constant data table from the reference (the custom id column, NOT the
# cityscapes trainId): (name, custom_id, color).
RGBLABEL_ROWS = [
    ("unlabeled", 0, (0, 0, 0)),
    ("motorcycle", 1, (0, 0, 230)),
    ("rider", 2, (255, 0, 0)),
    ("traffic light", 3, (250, 170, 30)),
    ("bus", 4, (0, 60, 100)),
    ("train", 5, (0, 80, 100)),
    ("truck", 6, (0, 0, 70)),
    ("bicycle", 7, (119, 11, 32)),
    ("traffic sign", 8, (220, 220, 0)),
    ("wall", 9, (102, 102, 156)),
    ("fence", 10, (190, 153, 153)),
    ("terrain", 11, (152, 251, 152)),
    ("person", 12, (220, 20, 60)),
    ("pole", 13, (153, 153, 153)),
    ("sky", 14, (70, 130, 180)),
    ("sidewalk", 15, (244, 35, 232)),
    ("car", 16, (0, 0, 142)),
    ("vegetation", 17, (107, 142, 35)),
    ("building", 18, (70, 70, 70)),
    ("road", 19, (128, 64, 128)),
]


def decode_rgb_label(label_rgb: np.ndarray) -> np.ndarray:
    """uint8 color label image [H, W, 3] -> uint8 class-id mask [H, W].

    Exact color matching against the 19 valid colors (unlabeled/unknown
    colors stay 0), replicating the b5 per-color equality loop
    (b5_preprocess_cityscapes_rgblabel_mask.py:205-223)."""
    rgb = np.asarray(label_rgb, np.uint8)
    out = np.zeros(rgb.shape[:2], np.uint8)
    for _, cid, color in RGBLABEL_ROWS[1:]:
        out[(rgb == np.asarray(color, np.uint8)).all(-1)] = cid
    return out


@dataclass
class PreprocessCityscapesRGBLabel:
    """b5 cooker: center-crop the frame + color label to ``crop_hw``, decode
    the label colors, and write ``{itemkey}_{C}x{H}x{W}.uint8.{X,Y}.npy``
    pairs with the reference's filename grammar (itemkey underscores become
    dashes; .npy replaces torch .pt)."""

    x_dir: str  # leftImg8bit frames
    y_dir: str  # gtFine *_gtFine_color.png renders
    out_dir: str
    crop_hw: tuple = (1024, 2048)

    def cook(self, max_samples: int = -1) -> list[str]:
        from PIL import Image

        os.makedirs(self.out_dir, exist_ok=True)
        key2x = {}
        for root, _, files in os.walk(self.x_dir):
            for f in files:
                if f.endswith(".png") and "_leftImg8bit" in f:
                    key2x[f.split("_leftImg8bit")[0]] = os.path.join(root, f)
        written = []
        for root, _, files in os.walk(self.y_dir):
            for f in sorted(files):
                if not f.endswith("_gtFine_color.png"):
                    continue
                key = f.split("_gtFine_color")[0]
                if key not in key2x:
                    continue
                x = np.asarray(Image.open(key2x[key]).convert("RGB"), np.uint8)
                y_rgb = np.asarray(Image.open(os.path.join(root, f)).convert("RGB"), np.uint8)
                ch, cw = self.crop_hw
                hs = max(0, x.shape[0] // 2 - ch // 2)
                ws = max(0, x.shape[1] // 2 - cw // 2)
                x = x[hs:hs + ch, ws:ws + cw]
                y = decode_rgb_label(y_rgb[hs:hs + ch, ws:ws + cw])
                itemkey = key.replace("_", "-")
                stem_y = f"{itemkey}_1x{y.shape[0]}x{y.shape[1]}.uint8.Y.npy"
                stem_x = f"{itemkey}_3x{x.shape[0]}x{x.shape[1]}.uint8.X.npy"
                np.save(os.path.join(self.out_dir, stem_y), y)
                np.save(os.path.join(self.out_dir, stem_x), x)
                written.append(stem_y)
                if 0 < max_samples <= len(written):
                    return written
        return written


class DatasetCityscapesRGBLabel:
    """Runtime twin of DatasetCityScapesRGBLabelMask (b5:261-333): yields
    (X float32 [H, W, 3] in [0,1], Y int32 [H, W] with ids 0..19)."""

    NUM_CLASS = len(RGBLABEL_ROWS)  # 20 (id 0 = unlabeled)

    def __init__(self, cook_dir: str):
        self.cook_dir = cook_dir
        self.names = sorted(n for n in os.listdir(cook_dir) if n.endswith(".Y.npy"))

    def __len__(self):
        return len(self.names)

    def class_ids(self) -> list[int]:
        """Each sample's training id, from the file names (no file read)."""
        return [convert_index(int(n.split(".")[0].split("_")[2][1:])) for n in self.names]

    def __getitem__(self, idx: int) -> dict:
        fname_y = self.names[idx]
        itemkey, ixhxw = fname_y.split(".")[0].split("_")
        fname_x = f"{itemkey}_3x{ixhxw[2:]}.uint8.X.npy"
        y = np.load(os.path.join(self.cook_dir, fname_y)).astype(np.int32)
        x = np.load(os.path.join(self.cook_dir, fname_x)).astype(np.float32) / 255.0
        return {"img_data": x, "seg_label": y}
