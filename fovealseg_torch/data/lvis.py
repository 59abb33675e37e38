"""LVIS 50-class cooker and reader (counterpart of ``fovealseg_tpu/data/lvis.py``).

* ``PreprocessLVIS`` reads an LVIS annotation json (with a pickle cache
  beside it), rasterizes one annotation's polygons, picks a gaze pixel inside
  the mask with ``random.Random(seed)``, centres the frame on a square
  canvas, and writes the mask as ``<name>.Y.npy``. The name carries the
  metadata: ``lvis_c{kid:04d}_k{kid}_a{ann}_{image}_{gy}x{gx}_{l}x{r}x{t}x{b}_1x{C}x{C}``.
  The draws, their order and the names are the JAX cooker's, so the cooked
  trees are byte-equal.
* ``DatasetLVIS`` reads a cooked tree back: (image, gaze / canvas, padded
  mask, class id). Without ``image_root``, or where ``{image}.jpg`` is
  missing, an item takes a random texture seeded by its image id, as the JAX
  reader does; the reader logs once how many of its items do.
  ``batches(..., rank, world)`` gives rank ``rank``'s contiguous block of
  each global batch, so the ranks' blocks put together are the global batch.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
from dataclasses import dataclass

import numpy as np

# 49 monitored LVIS category ids (b2_preprocess_lvis.py:529-629)
CIDS_MONITORED = [
    3, 12, 19, 36, 50, 61, 66, 76, 77, 90, 94, 96, 110, 118, 139, 143, 150,
    154, 169, 173, 181, 183, 207, 225, 230, 271, 277, 296, 346, 347, 350,
    351, 361, 378, 387, 392, 421, 422, 445, 461, 496, 498, 569, 589, 592,
    595, 631, 687, 694,
]

# LVIS category id -> contiguous id (train_deform_semantic.py:57)
ORIGINAL_IDX_TO_NEW_IDX = {
    77: 0, 421: 1, 816: 2, 1115: 3, 225: 4, 173: 5, 1052: 6, 982: 7, 1021: 8,
    1050: 9, 76: 10, 110: 11, 361: 12, 1097: 13, 631: 14, 422: 15, 378: 16,
    687: 17, 1077: 18, 912: 19, 183: 20, 445: 21, 1019: 22, 818: 23, 496: 24,
    817: 25, 3: 26, 698: 27, 703: 28, 766: 29, 1123: 30, 19: 31, 1202: 32,
    1071: 33, 1042: 34, 694: 35, 296: 36, 569: 37, 1117: 38, 1064: 39,
    961: 40, 350: 41, 461: 42, 169: 43, 1043: 44, 392: 45, 36: 46, 90: 47,
    181: 48, 139: 49, 150: 50, 1139: 51, 271: 52, 80: 53, 828: 54, 346: 55,
    748: 56, 923: 57, 143: 58, 351: 59, 804: 60, 793: 61, 1142: 62, 230: 63,
    898: 64, 94: 65, 719: 66, 1037: 67, 713: 68, 1110: 69, 836: 70, 708: 71,
    1133: 72, 589: 73, 1008: 74, 692: 75, 118: 76, 96: 77, 1060: 78, 61: 79,
    498: 80, 595: 81, 968: 82, 277: 83, 947: 84, 387: 85, 50: 86, 1026: 87,
    835: 88, 66: 89, 207: 90, 592: 91, 881: 92, 976: 93, 716: 94, 347: 95,
    1190: 96, 154: 97, 1079: 98, 1177: 99,
}


def convert_index(original_index: int) -> int:
    return ORIGINAL_IDX_TO_NEW_IDX.get(original_index, 0)


def rasterize_polygon(poly_xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """Fill a polygon given [N, 2] (x, y) vertices -> bool [h, w].

    Even-odd scanline fill matching skimage.draw.polygon semantics closely
    (the reference rasterizer, b2_preprocess_lvis.py:286-297).
    """
    mask = np.zeros((h, w), dtype=bool)
    xs, ys = poly_xy[:, 0], poly_xy[:, 1]
    n = len(xs)
    if n < 3:
        return mask
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), h - 1)
    for y in range(y0, y1 + 1):
        nodes = []
        j = n - 1
        for i in range(n):
            if (ys[i] < y) != (ys[j] < y):
                nodes.append(xs[i] + (y - ys[i]) / (ys[j] - ys[i]) * (xs[j] - xs[i]))
            j = i
        nodes.sort()
        for k in range(0, len(nodes) - 1, 2):
            a = max(int(np.ceil(nodes[k])), 0)
            b = min(int(np.floor(nodes[k + 1])), w - 1)
            if b >= a:
                mask[y, a : b + 1] = True
    return mask


@dataclass
class Sample:
    fname: str
    mask: np.ndarray  # bool [H, W] (before padding)
    gaze_hw: tuple[int, int]  # on the padded canvas
    paddings: tuple[int, int, int, int]  # left, right, top, bottom
    kid: int
    image_id: int


class PreprocessLVIS:
    """The offline cooker."""

    def __init__(self, lvis_json: str, out_dir: str, canvas: int = 640, seed: int = 0):
        self.canvas = canvas
        self.out_dir = out_dir
        self.rng = random.Random(seed)
        self.info = self._get_info(lvis_json)

    def _get_info(self, path: str) -> dict:
        """The json's images by id and annotations by category, cached in
        ``<json>.pkl`` (read back when present)."""
        cache = path + ".pkl"
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        with open(path) as f:
            raw = json.load(f)
        info = {
            "images": {im["id"]: im for im in raw.get("images", [])},
            "by_cat": {},
        }
        for ann in raw.get("annotations", []):
            info["by_cat"].setdefault(ann["category_id"], []).append(ann)
        with open(cache, "wb") as f:
            pickle.dump(info, f)
        return info

    def make_a_sample(self, ann: dict, caty: str = "lvis") -> Sample | None:
        """Rasterize one annotation; None when its image is missing, larger
        than the canvas, or its mask is empty."""
        img = self.info["images"].get(ann["image_id"])
        if img is None:
            return None
        h, w = img["height"], img["width"]
        if h > self.canvas or w > self.canvas:
            return None
        mask = np.zeros((h, w), dtype=bool)
        for seg in ann.get("segmentation", []):
            poly = np.asarray(seg, dtype=np.float64).reshape(-1, 2)
            mask |= rasterize_polygon(poly, h, w)
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            return None
        k = self.rng.randrange(len(ys))
        # centred on the canvas
        pad_top = (self.canvas - h) // 2
        pad_bottom = self.canvas - h - pad_top
        pad_left = (self.canvas - w) // 2
        pad_right = self.canvas - w - pad_left
        gaze = (int(ys[k]) + pad_top, int(xs[k]) + pad_left)
        kid = ann["category_id"]
        fname = (
            f"{caty}_c{kid:04d}_k{kid}_a{ann['id']}_{ann['image_id']}_"
            f"{gaze[0]}x{gaze[1]}_{pad_left}x{pad_right}x{pad_top}x{pad_bottom}_"
            f"1x{self.canvas}x{self.canvas}"
        )
        return Sample(fname, mask, gaze, (pad_left, pad_right, pad_top, pad_bottom), kid,
                      ann["image_id"])

    def make_n_samples(self, n: int, cids=None, marker: str = "") -> list[str]:
        """Round-robin over the monitored classes, a random annotation of
        each; writes ``<fname>.Y.npy`` into ``out_dir/marker`` (``out_dir``
        when ``marker`` is empty). Gives up after ``20 n`` draws."""
        cids = cids or [c for c in CIDS_MONITORED if c in self.info["by_cat"]]
        out_dir = os.path.join(self.out_dir, marker) if marker else self.out_dir
        os.makedirs(out_dir, exist_ok=True)
        written = []
        i = 0
        guard = 0
        while len(written) < n and guard < n * 20:
            guard += 1
            cid = cids[i % len(cids)]
            anns = self.info["by_cat"].get(cid, [])
            if not anns:
                i += 1
                continue
            s = self.make_a_sample(self.rng.choice(anns))
            i += 1
            if s is None:
                continue
            path = os.path.join(out_dir, s.fname + ".Y.npy")
            np.save(path, s.mask)
            written.append(path)
        return written


def rank_block(idxs, rank: int, world: int):
    """Rank ``rank``'s contiguous block of one global batch's indices."""
    if len(idxs) % world:
        raise ValueError(f"a global batch of {len(idxs)} does not split over {world} ranks")
    per = len(idxs) // world
    return idxs[rank * per:(rank + 1) * per]


def stack(samples: list) -> dict:
    """Item dicts -> one batch dict (each key stacked on a new axis 0)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DatasetLVIS:
    """The reader over a cooked tree: NHWC numpy item dicts."""

    def __init__(self, cook_dir: str, image_root: str | None = None,
                 canvas: int = 640, marker: str = ""):
        """``marker`` selects the ``cook_dir/marker`` set, and the flat
        ``cook_dir`` is read when that subdirectory is absent. A missing
        ``cook_dir`` raises."""
        self.canvas = canvas
        self.image_root = image_root
        self.items = []
        if marker and os.path.isdir(os.path.join(cook_dir, marker)):
            cook_dir = os.path.join(cook_dir, marker)
        for name in sorted(os.listdir(cook_dir)):
            if not name.endswith(".Y.npy"):
                continue
            stem = name[: -len(".Y.npy")]
            caty, cid, kid, aid, imgid, fpos, paddings, ihw = stem.split("_")
            pl, pr, pt, pb = map(int, paddings.split("x"))
            gy, gx = map(int, fpos.split("x"))
            self.items.append(
                dict(
                    path=os.path.join(cook_dir, name),
                    image_id=int(imgid),
                    cls=convert_index(int(kid[1:])),
                    gaze=(gy, gx),
                    pad=(pl, pr, pt, pb),
                )
            )
        self.n_textured = sum(self._image_path(it) is None for it in self.items)
        if self.n_textured:
            logging.getLogger("fovealseg").warning(
                "DatasetLVIS %s: %d of %d samples have no image%s and take a seeded random "
                "texture", cook_dir, self.n_textured, len(self.items),
                f" under {image_root}" if image_root else " (no image root)")

    def __len__(self):
        return len(self.items)

    def class_ids(self) -> list[int]:
        """Each sample's training id, from the file names (no file read)."""
        return [it["cls"] for it in self.items]

    def __getitem__(self, idx: int) -> dict:
        it = self.items[idx]
        mask = np.load(it["path"])
        pl, pr, pt, pb = it["pad"]
        seg = np.pad(mask.astype(np.float32), ((pt, pb), (pl, pr)))
        img = self._load_image(it, seg.shape)
        focus = np.asarray(
            [it["gaze"][0] / self.canvas, it["gaze"][1] / self.canvas], np.float32
        )
        return {
            "img_data": img,
            "focus_point": focus,
            "seg_label": seg,
            "cls_label": np.int32(it["cls"]),
        }

    def _image_path(self, it: dict) -> str | None:
        if self.image_root:
            p = os.path.join(self.image_root, f"{it['image_id']}.jpg")
            if os.path.exists(p):
                return p
        return None

    def _load_image(self, it: dict, shape) -> np.ndarray:
        p = self._image_path(it)
        if p is not None:
            from PIL import Image

            im = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
            pl, pr, pt, pb = it["pad"]
            return np.pad(im, ((pt, pb), (pl, pr), (0, 0)))
        # no image: a texture seeded by the image id
        rng = np.random.default_rng(it["image_id"] % (2**31))
        return rng.uniform(0, 1, (*shape, 3)).astype(np.float32)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, rank: int = 0, world: int = 1):
        """Global batches of ``batch_size`` in the JAX reader's order (a
        ``default_rng(seed)`` shuffle), each cut to rank ``rank``'s
        contiguous block of ``batch_size // world`` items; only that block is
        read."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1 if drop_last else len(order), batch_size):
            idxs = rank_block(order[i : i + batch_size], rank, world)
            yield stack([self[int(j)] for j in idxs])
