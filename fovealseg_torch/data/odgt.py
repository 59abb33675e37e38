"""ODGT datasets: the ADE20K, Cityscapes, GLEASON and Digest families
(counterpart of ``fovealseg_tpu/data/odgt.py``).

Json-lines ``.odgt`` lists, the label mappings and normalisation constants
of each family, the "-1 shift" (labels stored 1..C, ignore becomes -1),
``TrainDataset``'s aspect-ratio batches with short-edge scaling to
``imgSizes`` / ``imgMaxSize`` and ``padding_constant`` rounding, the
``DATASET.random_flip`` augmentation family, the rare-class filter, the
multi-scale ``ValDataset`` with its central crop, and the patch walk of
``TestDataset``.

NHWC numpy output. Images load and resize with PIL (``BILINEAR`` for
images, ``NEAREST`` for labels) exactly where the JAX file does: the
resizes are part of the numbers.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

import numpy as np

# per-family normalization constants (BaseDataset:107-196)
NORMALIZATION = {
    "gleason": ([0.748, 0.611, 0.823], [0.146, 0.245, 0.119]),
    "digest": ([0.816, 0.697, 0.792], [0.160, 0.277, 0.198]),
    "ade": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "cityscapes": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "histo": ([0.8223, 0.7783, 0.7847], [0.210, 0.216, 0.241]),
    "deepglob": ([0.282, 0.379, 0.408], [0.089, 0.101, 0.127]),
}

# GLEASON class mappings keyed by opt.class_mapping (BaseDataset:64-105)
GLEASON_MAPPINGS = {
    0: {0: 1, 1: 1, 2: 1, 3: 2, 4: 3, 5: 4, 6: 1},
    30: {0: 1, 1: 1, 2: 1, 3: 2, 4: 3, 5: 1, 6: 1},
    3: {0: 1, 1: 1, 2: 1, 3: 2, 4: 1, 5: 1, 6: 1},
    4: {0: 1, 1: 1, 2: 1, 3: 1, 4: 2, 5: 1, 6: 1},
    5: {0: 1, 1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 6: 1},
    6: {0: 1, 1: 1, 2: 1, 3: 2, 4: 2, 5: 2, 6: 1},
}
DIGEST_MAPPING = {0: 1, 255: 2}
# Cityscapes trainId mapping (HRNet-Semantic-Segmentation convention,
# shifted +1 for the reference's 1-based storage; 255/-1 -> ignore 0)
CITYSCAPES_MAPPING = {
    7: 1, 8: 2, 11: 3, 12: 4, 13: 5, 17: 6, 19: 7, 20: 8, 21: 9, 22: 10,
    23: 11, 24: 12, 25: 13, 26: 14, 27: 15, 28: 16, 31: 17, 32: 18, 33: 19,
}


def detect_family(root_dataset: str, list_train: str) -> str:
    s = (root_dataset or "") + " " + (list_train or "")
    if "GLEASON" in s:
        return "gleason"
    if "Digest" in s:
        return "digest"
    if "cityscapes" in s.lower() or "CITYSCAPE" in s:
        return "cityscapes"
    if "histo" in s.lower():
        return "histo"
    if "DeepGlob" in s or "deepglob" in s.lower():
        return "deepglob"
    return "ade"


def family_label_mapping(family: str, class_mapping: int = 0, binary_class: int = -1) -> dict:
    if family == "gleason":
        return GLEASON_MAPPINGS.get(class_mapping, GLEASON_MAPPINGS[0])
    if family == "digest":
        return DIGEST_MAPPING
    if family == "cityscapes":
        if binary_class != -1:
            # DATASET.binary_class (dataset.py:134-144). NOTE: the reference
            # builds the dict with an unguarded if/else whose else-branch
            # overwrites the ignore assignments, so the *effective* mapping is
            # "binary_class -> 2, every other id (ignores included) -> 1";
            # replicated faithfully.
            return {i: (2 if i == binary_class else 1) for i in range(-1, 34)}
        return CITYSCAPES_MAPPING
    return {}


# config keys present in the reference's DATASET group but never read by any
# reference code path (defaults.py:32-34 — grep-verified dead): accepting and
# ignoring them IS the parity behavior, but do it loudly.
DEAD_REFERENCE_OPTIONS = ("multi_scale_aug", "adjust_crop_range", "mirror_padding")


def warn_dead_options(cfg, logger=None) -> list[str]:
    """Warn for DATASET options that are dead keys in the reference itself."""
    import logging

    logger = logger or logging.getLogger("fovealseg")
    hit = [k for k in DEAD_REFERENCE_OPTIONS if getattr(cfg.DATASET, k, False)]
    for k in hit:
        logger.warning(
            "DATASET.%s is set but is a dead config key in the reference "
            "(defined at config/defaults.py:32-34, never read); ignoring it "
            "reproduces reference behavior", k,
        )
    return hit


def parse_odgt(odgt, max_sample: int = -1, start_idx: int = -1, end_idx: int = -1):
    """.odgt json-lines -> list of dicts (BaseDataset:240-252)."""
    if isinstance(odgt, str):
        with open(odgt) as f:
            samples = [json.loads(line) for line in f if line.strip()]
    else:
        samples = list(odgt)
    if max_sample > 0:
        samples = samples[:max_sample]
    if start_idx >= 0 and end_idx >= 0:
        samples = samples[start_idx:end_idx]
    assert samples, "empty odgt"
    return samples


def round2nearest_multiple(x: int, p: int) -> int:
    return ((x - 1) // p + 1) * p


@dataclass
class OdgtDataset:
    """Shared loading/transform machinery (BaseDataset equivalent)."""

    root_dataset: str
    odgt: object
    num_class: int = 150
    class_mapping: int = 0
    list_train: str = ""
    imgSizes: tuple = (300, 375, 450, 525, 600)
    imgMaxSize: int = 1000
    padding_constant: int = 8
    segm_downsampling_rate: int = 8
    random_flip: str = "Flip"
    binary_class: int = -1  # DATASET.binary_class (cityscapes fg-vs-rest)
    repeat_sample: int = 0  # DATASET.repeat_sample (dataset.py:313-367)
    gt_gradient_rm_under_repre: float = 0.0  # dataset.py:322-335
    val_central_crop: bool = False  # dataset.py:638-650
    val_central_crop_shape: tuple = (300, 300)
    # VAL.expand_prediection_rate (sic): scales the val pyramid sizes
    # (ValDataset.__init__, dataset.py:623-628); only ValDataset reads it
    expand_prediection_rate: float = 1.0
    samples: list = field(default_factory=list)

    def __post_init__(self):
        self.samples = parse_odgt(self.odgt)
        self.family = detect_family(self.root_dataset, self.list_train)
        self.mean, self.std = NORMALIZATION[self.family]
        self.label_mapping = family_label_mapping(
            self.family, self.class_mapping, self.binary_class
        )

    def __len__(self):
        return len(self.samples)

    # -- transforms ---------------------------------------------------------
    def img_transform(self, img: np.ndarray) -> np.ndarray:
        """uint8 HWC -> normalized float32 HWC (BaseDataset:257-262)."""
        x = np.asarray(img, np.float32) / 255.0
        return (x - np.asarray(self.mean, np.float32)) / np.asarray(self.std, np.float32)

    def convert_label(self, segm: np.ndarray) -> np.ndarray:
        """family mapping only, no shift (BaseDataset.convert_label)."""
        s = np.asarray(segm, np.int64)
        if self.label_mapping:
            out = np.zeros_like(s)
            for k, v in self.label_mapping.items():
                out[s == k] = v
            s = out
        return s

    def segm_transform(self, segm: np.ndarray) -> np.ndarray:
        """apply family mapping then the 1-based -> 0-based '-1' shift
        (ignore becomes -1; dataset.py:278-283)."""
        return self.convert_label(segm) - 1

    def _load_pair(self, rec: dict):
        from PIL import Image

        img = Image.open(os.path.join(self.root_dataset, rec["fpath_img"])).convert("RGB")
        segm = Image.open(os.path.join(self.root_dataset, rec["fpath_segm"]))
        return img, segm

    def _scaled_size(self, w: int, h: int, this_short_size: float,
                     max_size: float | None = None):
        """Target (w, h) for one pyramid level. ``max_size`` overrides
        imgMaxSize; 1 means scale=1 (the central-crop imgMaxSize_val=1
        convention, dataset.py:650,663-665)."""
        max_size = self.imgMaxSize if max_size is None else max_size
        if max_size == 1:
            scale = 1.0
        else:
            scale = min(this_short_size / float(min(h, w)), max_size / float(max(h, w)))
        tw = round2nearest_multiple(int(w * scale), self.padding_constant)
        th = round2nearest_multiple(int(h * scale), self.padding_constant)
        return tw, th


class TrainDataset(OdgtDataset):
    """Aspect-ratio-grouped random batches (TrainDataset:290-561).

    ``DATASET.random_flip`` selects the augmentation family
    (dataset.py:306,461-561). Every mode is implemented numpy-native
    (albumentations is not shipped here); the noise/crop parameter families
    match the albumentations defaults the reference composes, but the RNG
    streams necessarily differ (same caveat as the b3 cooker):

    - ``Flip``: horizontal flip p=0.5 (dataset.py:461-464)
    - ``Flip_Pixel``: GaussNoise(var 10-50, p=.5) + RandomBrightnessContrast
      (+-0.2, p=.5) + Flip(h/v/both, p=.5) (dataset.py:465-475)
    - ``cityHRaug``: RandomScale(x1.5-3.0, p=.5) + RandomCrop(512, 1024) +
      HorizontalFlip(p=.5) (dataset.py:476-486)
    - ``balance_sample``: every 4th batch slot rejection-samples
      RandomCrop(imgSizes[0], imgSizes[1]) + Flip until the last class holds
      >25 % of pixels (dataset.py:487-502); record *selection* also scans
      for rare-class-rich records every 3rd draw after the first three
      (balance_sam_idx > 2, dataset.py:338-355)
    - ``fullFoV_balance_sample``: every 4th slot resizes to the batch shape
      then rejection-flips on the same >25 % criterion (dataset.py:503-520)
    - ``Crop_Flip`` / ``Crop_aug_N`` / ``Crop_noaug_N``: RandomCrop to
      (imgSizes[0], imgSizes[1]) or N x N (clamped to the image), 'aug'
      adds brightness/contrast + multiplicative noise; + Flip
      (dataset.py:521-561)
    """

    # -- numpy augmentation primitives ---------------------------------

    @staticmethod
    def _aug_flip(img: np.ndarray, segm: np.ndarray, rng, horizontal_only: bool = False):
        """A.Flip semantics: one of h / v / both, p=0.5 overall."""
        if rng.random() < 0.5:
            return img, segm
        mode = 1 if horizontal_only else rng.choice([-1, 0, 1])
        if mode in (1, -1):  # horizontal
            img, segm = img[:, ::-1], segm[:, ::-1]
        if mode in (0, -1):  # vertical
            img, segm = img[::-1], segm[::-1]
        return img, segm

    @staticmethod
    def _aug_gauss_noise(img: np.ndarray, rng):
        """A.GaussNoise defaults: var uniform in [10, 50], p=0.5."""
        if rng.random() < 0.5:
            return img
        std = float(np.sqrt(rng.uniform(10.0, 50.0)))
        noise = rng.normal(0.0, std, img.shape)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)

    @staticmethod
    def _aug_brightness_contrast(img: np.ndarray, rng):
        """A.RandomBrightnessContrast defaults: limits +-0.2, p=0.5."""
        if rng.random() < 0.5:
            return img
        alpha = 1.0 + rng.uniform(-0.2, 0.2)  # contrast
        beta = rng.uniform(-0.2, 0.2) * 255.0  # brightness
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)

    @staticmethod
    def _aug_mult_noise(img: np.ndarray, rng):
        """A.MultiplicativeNoise defaults: multiplier in [0.9, 1.1], p=0.5."""
        if rng.random() < 0.5:
            return img
        m = rng.uniform(0.9, 1.1)
        return np.clip(img.astype(np.float32) * m, 0, 255).astype(np.uint8)

    @staticmethod
    def _aug_random_crop(img: np.ndarray, segm: np.ndarray, ch: int, cw: int, rng):
        """A.RandomCrop(height, width) — clamped to the image."""
        h, w = segm.shape[:2]
        ch, cw = min(ch, h), min(cw, w)
        top = rng.integers(0, h - ch + 1)
        left = rng.integers(0, w - cw + 1)
        return img[top:top + ch, left:left + cw], segm[top:top + ch, left:left + cw]

    def _rare_ok(self, segm: np.ndarray) -> bool:
        """The balance_sample acceptance test (dataset.py:494-501): the
        last class holds >25 % of the label-converted (UNshifted — the
        reference omits the -1 there) pixels."""
        s = self.convert_label(segm)
        hist, _ = np.histogram(s, bins=self.num_class, range=(0, self.num_class - 1))
        total = hist.sum()
        return bool(total > 0 and hist[-1] / total > 0.25)

    def _rare_record(self, idx: int) -> bool:
        """Record-level rare-class scan for balance_sample selection
        (dataset.py:338-355). Memoized like _well_represented."""
        cache = getattr(self, "_rare_cache", None)
        if cache is None:
            cache = self._rare_cache = {}
        if idx not in cache:
            from PIL import Image

            rec = self.samples[idx]
            segm = Image.open(os.path.join(self.root_dataset, rec["fpath_segm"]))
            cache[idx] = self._rare_ok(np.asarray(segm))
        return cache[idx]

    def _augment(self, img, segm, slot: int, pyrng, target_wh):
        """Dispatch on self.random_flip; takes/returns PIL images.
        ``pyrng`` is the batch stream's random.Random; the numpy-based
        modes derive a deterministic np Generator from it."""
        from PIL import Image

        mode = self.random_flip
        if mode == "Flip":
            if pyrng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                segm = segm.transpose(Image.FLIP_LEFT_RIGHT)
            return img, segm
        if not mode or mode == "none":
            return img, segm

        rng = np.random.default_rng(pyrng.getrandbits(64))
        ai, as_ = np.asarray(img), np.asarray(segm)
        if mode == "Flip_Pixel":
            ai = self._aug_gauss_noise(ai, rng)
            ai = self._aug_brightness_contrast(ai, rng)
            ai, as_ = self._aug_flip(ai, as_, rng)
        elif mode == "cityHRaug":
            if rng.random() < 0.5:  # A.RandomScale p=0.5; factor 1 + U(0.5, 2)
                f = 1.0 + rng.uniform(0.5, 2.0)
                nw, nh = int(ai.shape[1] * f), int(ai.shape[0] * f)
                ai = np.asarray(Image.fromarray(ai).resize((nw, nh), Image.BILINEAR))
                as_ = np.asarray(Image.fromarray(as_).resize((nw, nh), Image.NEAREST))
            ai, as_ = self._aug_random_crop(ai, as_, 512, 1024, rng)
            ai, as_ = self._aug_flip(ai, as_, rng, horizontal_only=True)
        elif mode == "balance_sample":
            if (slot + 1) % 4 == 0:
                ch, cw = int(self.imgSizes[0]), int(self.imgSizes[1])
                for _ in range(64):  # bounded rejection (ref loops forever)
                    ci, cs = self._aug_random_crop(ai, as_, ch, cw, rng)
                    ci, cs = self._aug_flip(ci, cs, rng)
                    if self._rare_ok(cs):
                        ai, as_ = ci, cs
                        break
        elif mode == "fullFoV_balance_sample":
            if (slot + 1) % 4 == 0:
                tw, th = target_wh
                ai = np.asarray(Image.fromarray(ai).resize((tw, th), Image.BILINEAR))
                as_ = np.asarray(Image.fromarray(as_).resize((tw, th), Image.NEAREST))
                # the acceptance test is a class histogram — flip-invariant —
                # so one check decides (the reference's rejection loop over
                # identity-crop+flip can never change the verdict,
                # dataset.py:503-520, and spins forever on a miss)
                if self._rare_ok(as_):
                    ai, as_ = self._aug_flip(ai, as_, rng)
        elif mode.split("_")[0] == "Crop":
            do_crop = True
            if mode == "Crop_Flip":
                ch, cw = int(self.imgSizes[0]), int(self.imgSizes[1])
            else:
                n = int(mode.split("_")[-1])
                ch = cw = n
                # reference fallback (dataset.py:528-532): when either
                # dimension is smaller than N the whole image is used uncropped
                if as_.shape[0] < n or as_.shape[1] < n:
                    do_crop = False
            if do_crop:
                ai, as_ = self._aug_random_crop(ai, as_, ch, cw, rng)
            if mode.split("_")[1] == "aug":
                ai = self._aug_brightness_contrast(ai, rng)
                ai = self._aug_mult_noise(ai, rng)
            ai, as_ = self._aug_flip(ai, as_, rng)
        else:
            # the reference's if/elif chain has no else: unknown modes train
            # unaugmented (dataset.py:461-561) — warn loudly, then match it
            import warnings

            warnings.warn(
                f"unknown DATASET.random_flip mode {mode!r}: no augmentation "
                "applied (reference behavior)", stacklevel=2)
        return Image.fromarray(np.ascontiguousarray(ai)), Image.fromarray(np.ascontiguousarray(as_))

    def _well_represented(self, idx: int) -> bool:
        """DATASET.gt_gradient_rm_under_repre (dataset.py:322-335): for
        binary tasks, require the foreground (last) class to exceed the
        configured fraction of pixels. Memoized — one label decode per
        record per dataset lifetime."""
        cache = getattr(self, "_repre_cache", None)
        if cache is None:
            cache = self._repre_cache = {}
        if idx not in cache:
            rec = self.samples[idx]
            from PIL import Image

            segm = Image.open(os.path.join(self.root_dataset, rec["fpath_segm"]))
            s = self.segm_transform(np.asarray(segm))
            hist, _ = np.histogram(s, bins=self.num_class, range=(0, self.num_class - 1))
            total = hist.sum()
            cache[idx] = bool(total > 0 and (hist[-1] / total) > self.gt_gradient_rm_under_repre)
        return cache[idx]

    def _sample_stream(self, order, rng):
        """Yields sample indices honoring repeat_sample (each record is drawn
        ``repeat_sample`` times before advancing, dataset.py:313-367) and
        gt_gradient_rm_under_repre (scan forward, wrapping, to the next
        well-represented sample, dataset.py:322-335). Bounded: one epoch
        emits exactly len(order) draws (x repeat_sample); if no sample
        passes the filter the remaining draws fall back to the unfiltered
        record instead of spinning (the reference would loop forever there)."""
        filter_on = self.gt_gradient_rm_under_repre > 0 and self.num_class == 2
        balance_on = self.random_flip == "balance_sample"
        balance_idx = 0  # the reference's balance_sam_idx (dataset.py:338-356)
        n = len(order)
        scan = 0  # persistent scan pointer (the reference's cur_idx)
        for draw in range(n):
            idx = order[draw]
            if filter_on:
                for tries in range(n):
                    cand = order[(scan + tries) % n]
                    if self._well_represented(cand):
                        idx = cand
                        scan = (scan + tries + 1) % n
                        break
            if balance_on and balance_idx > 2:
                # every 3rd draw after the first three (balance_sam_idx > 2,
                # reset-then-increment — the reference's own comment says
                # "every 3 steps", dataset.py:338-340), scan forward FROM THE
                # CURRENT DRAW POSITION (the reference scans from cur_idx,
                # dataset.py:342) for a rare-class-rich record. Deviation:
                # the reference also advances its main pointer past the found
                # record (skipping the records in between); here the epoch
                # still visits every record once — bounded-epoch semantics.
                for tries in range(n):
                    cand = order[(draw + tries) % n]
                    if self._rare_record(cand):
                        idx = cand
                        break
                balance_idx = 0
            balance_idx += 1
            for _ in range(max(1, self.repeat_sample)):
                yield idx

    def batches(self, batch_per_gpu: int, seed: int = 0):
        rng = random.Random(seed)
        order = list(range(len(self.samples)))
        rng.shuffle(order)
        groups = [[], []]  # h > w, h <= w (dataset.py:314-334)
        for idx in self._sample_stream(order, rng):
            rec = self.samples[idx]
            groups[0 if rec["height"] > rec["width"] else 1].append(idx)
            g = groups[0] if len(groups[0]) >= batch_per_gpu else (
                groups[1] if len(groups[1]) >= batch_per_gpu else None
            )
            if g is None:
                continue
            batch_idx = g[:batch_per_gpu]
            del g[:batch_per_gpu]
            yield self._make_batch(batch_idx, rng)

    def _make_batch(self, idxs, rng):
        from PIL import Image

        this_short_size = rng.choice(self.imgSizes)
        recs = [self.samples[i] for i in idxs]
        sizes = [self._scaled_size(r["width"], r["height"], this_short_size) for r in recs]
        bw = max(s[0] for s in sizes)
        bh = max(s[1] for s in sizes)
        r = self.segm_downsampling_rate
        imgs = np.zeros((len(recs), bh, bw, 3), np.float32)
        segms = np.full((len(recs), bh // r, bw // r), -1, np.int64)
        for i, (rec, (tw, th)) in enumerate(zip(recs, sizes)):
            img, segm = self._load_pair(rec)
            img, segm = self._augment(img, segm, i, rng, (tw, th))
            img = img.resize((tw, th), Image.BILINEAR)
            segm = segm.resize((tw, th), Image.NEAREST)
            imgs[i, :th, :tw] = self.img_transform(np.asarray(img))
            sd = segm.resize((tw // r, th // r), Image.NEAREST)
            segms[i, : th // r, : tw // r] = self.segm_transform(np.asarray(sd))
        return {"img_data": imgs, "seg_label": segms}


class ValDataset(OdgtDataset):
    """Single-sample multi-scale eval records (ValDataset:618-713)."""

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        rec = self.samples[idx]
        img, segm = self._load_pair(rec)
        # VAL.expand_prediection_rate scales the whole val pyramid
        # (imgSizes_val/imgMaxSize_val, dataset.py:623-628)
        rate = self.expand_prediection_rate
        sizes = self.imgSizes if isinstance(self.imgSizes, (list, tuple)) else [self.imgSizes]
        sizes = [s * rate for s in sizes]
        max_size = self.imgMaxSize * rate
        if self.val_central_crop:
            # DATASET.val_central_crop(_shape): center crop before the
            # multi-scale pyramid, then imgMaxSize_val = 1 — every pyramid
            # level feeds the crop at original resolution (scale = 1,
            # padding-rounded only; dataset.py:638-665)
            cw, ch = self.val_central_crop_shape
            w, h = img.size
            box = ((w - cw) / 2, (h - ch) / 2, (w + cw) / 2, (h + ch) / 2)
            img = img.crop(box)
            segm = segm.crop(box)
            max_size = 1
        w, h = img.size
        img_list = []
        for short in sizes:
            tw, th = self._scaled_size(w, h, short, max_size=max_size)
            scaled = img.resize((tw, th), Image.BILINEAR)
            img_list.append(self.img_transform(np.asarray(scaled))[None])
        return {
            "img_ori": np.asarray(img, np.float32) / 255.0,
            "img_data": img_list,
            "seg_label": self.segm_transform(np.asarray(segm))[None],
            "info": rec.get("fpath_img", str(idx)),
        }


class TestDataset(OdgtDataset):
    """Label-free patch-cropping test records (TestDataset:716-808).

    Tiles the image into ``patch_size`` x ``patch_size`` crops (grid walk
    with edge clamping, dataset.py:724-768 — the reference's inclusive
    iteration bounds produce duplicate edge crops for exactly-divisible
    sizes; kept for parity), builds the multi-scale pyramid per crop, and
    returns ``(crop_outputs, coordinate_list, ori_size)``. ``patch_size``
    follows the reference grammar: parsed from a ``train268_<N>_`` token in
    ``list_train`` for gleason2019, else 5000.

    Deviation: images load as RGB; the reference loads with cv2 (BGR) and
    never swaps channels before its RGB-calibrated normalization
    (dataset.py:737,777) — an upstream bug not reproduced.
    """

    def _patch_size(self) -> int:
        if "gleason2019" in (self.list_train or ""):
            return int(self.list_train.split("train268_")[1].split("_")[0])
        return 5000

    @staticmethod
    def _tile_starts(size: int, patch: int) -> list[int]:
        """Reference grid walk for one axis (dataset.py:739-758)."""
        n = size // patch  # overlap = 0
        starts = []
        for i in range(n + 1):
            if i == 0 or size < patch:
                starts.append(0)
            elif i == n:
                starts.append(size - patch)
            else:
                starts.append(i * patch)
        return starts

    def __getitem__(self, idx: int):
        from PIL import Image

        rec = self.samples[idx]
        img = Image.open(os.path.join(self.root_dataset, rec["fpath_img"])).convert("RGB")
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        patch = self._patch_size()
        px, py = min(patch, w), min(patch, h)
        sizes = self.imgSizes if isinstance(self.imgSizes, (list, tuple)) else [self.imgSizes]

        crop_outputs = []
        coordinate_list = []
        for cx in self._tile_starts(w, patch):
            for cy in self._tile_starts(h, patch):
                coordinate_list.append([cx, cy])
                crop = arr[cy:cy + py, cx:cx + px]
                ch, cw = crop.shape[:2]
                img_list = []
                for short in sizes:
                    tw, th = self._scaled_size(cw, ch, short)
                    scaled = Image.fromarray(crop).resize((tw, th), Image.BILINEAR)
                    img_list.append(self.img_transform(np.asarray(scaled))[None])
                crop_outputs.append({
                    "img_ori": crop.copy(),
                    "img_data": img_list,
                    "info": rec.get("fpath_img", str(idx)),
                })
        return crop_outputs, coordinate_list, (w, h)
