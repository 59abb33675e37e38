"""Port: the dataset readers and cookers (``fovealseg_torch/data``) against
the JAX package's (``fovealseg_tpu/data``) on tiny files that the tests
write, with the same seeds.

Cooked file trees must hold the same names with byte-equal contents, and
item dicts and ``batches`` output must be bit-equal (same keys, dtypes,
shapes and bytes): LVIS (with and without images, markers), Cityscapes
(both cookers and both readers), Aria and the ODGT readers (train with the
augmentation family, the rare-class and under-representation filters, val
with the pyramid and the central crop, test with the patch walk). The rank
blocks of world 1, 2 and 4 put together must equal the global batch.
"""

import json
import logging
import os

import numpy as np
import pytest
from PIL import Image

from fovealseg_torch.data import aria_adt, cityscapes, loader, lvis, odgt
from fovealseg_tpu.data import aria_adt as j_aria
from fovealseg_tpu.data import cityscapes as j_city
from fovealseg_tpu.data import loader as j_loader
from fovealseg_tpu.data import lvis as j_lvis
from fovealseg_tpu.data import odgt as j_odgt
from torch_port_files import lvis_json


def assert_same(a, b, where="item"):
    """Bit-equal: dicts by key, sequences by position, arrays by dtype,
    shape and bytes, anything else by ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    assert ta, "nothing was cooked"
    for k in ta:
        assert ta[k] == tb[k], k


# ------------------------------------------------------------------- LVIS

def cook_lvis(mod, tmp, name, n=12, marker="sp12"):
    d = tmp / name
    d.mkdir()
    j = lvis_json(str(d / "lvis.json"))
    pre = mod.PreprocessLVIS(j, str(d / "cook"), canvas=64, seed=5)
    written = pre.make_n_samples(n, marker=marker)
    return d, written


def test_lvis_tables_and_rasterizer():
    assert lvis.CIDS_MONITORED == j_lvis.CIDS_MONITORED
    assert lvis.ORIGINAL_IDX_TO_NEW_IDX == j_lvis.ORIGINAL_IDX_TO_NEW_IDX
    rng = np.random.default_rng(3)
    for _ in range(20):
        poly = rng.uniform(-3, 30, (int(rng.integers(2, 9)), 2))
        assert_same(lvis.rasterize_polygon(poly, 25, 28), j_lvis.rasterize_polygon(poly, 25, 28))
    for k in (77, 150, 3, 999999):
        assert lvis.convert_index(k) == j_lvis.convert_index(k)


@pytest.mark.parametrize("marker", ["sp12", ""])
def test_lvis_cooked_tree_byte_equal(tmp_path, marker):
    """The same draws in the same order: the same names, the same .npy
    bytes, the same pickle cache."""
    d1, w1 = cook_lvis(lvis, tmp_path, "port", marker=marker)
    d2, w2 = cook_lvis(j_lvis, tmp_path, "jax", marker=marker)
    assert [os.path.relpath(p, d1) for p in w1] == [os.path.relpath(p, d2) for p in w2]
    assert len(w1) == 12
    assert_same_tree(d1, d2)


@pytest.fixture(scope="module")
def lvis_cooked(tmp_path_factory):
    """One cooked tree, and JPEGs for all but two image ids."""
    tmp = tmp_path_factory.mktemp("lvis")
    d, _ = cook_lvis(j_lvis, tmp, "c", n=12)
    img_root = tmp / "images"
    img_root.mkdir()
    rng = np.random.default_rng(9)
    with open(d / "lvis.json") as f:
        images = json.load(f)["images"]
    for im in images[2:]:
        arr = rng.integers(0, 256, (im["height"], im["width"], 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_root / f"{im['id']}.jpg", quality=90)
    return d / "cook", img_root


@pytest.mark.parametrize("with_images", [False, True], ids=["no_images", "images"])
def test_lvis_reader_items_and_batches(lvis_cooked, with_images, caplog):
    cook, img_root = lvis_cooked
    root = str(img_root) if with_images else None
    with caplog.at_level(logging.WARNING, logger="fovealseg"):
        ds = lvis.DatasetLVIS(str(cook), root, canvas=64, marker="sp12")
    ref = j_lvis.DatasetLVIS(str(cook), root, canvas=64, marker="sp12")
    assert len(ds) == len(ref) == 12
    assert_same(ds.items, ref.items, "items")
    for i in range(len(ds)):
        assert_same(ds[i], ref[i], f"item {i}")
    for kw in (dict(shuffle=True, seed=4), dict(shuffle=False),
               dict(shuffle=False, drop_last=False)):
        got = list(ds.batches(5, **kw))
        assert_same(got, list(ref.batches(5, **kw)), f"batches {kw}")
    # the seeded-texture fallback is logged once, with its count
    textured = [it for it in ds.items if not with_images or it["image_id"] in (1, 2)]
    assert ds.n_textured == len(textured) > 0
    assert f"{len(textured)} of 12 samples have no image" in caplog.text
    # a marker without a subdirectory reads the flat root (no cooked file there)
    assert len(lvis.DatasetLVIS(str(cook), canvas=64, marker="nope")) == 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_lvis_rank_blocks_make_the_global_batch(lvis_cooked, world):
    """Each rank reads only its contiguous block; the blocks put together
    are the JAX reader's global batch, bit for bit."""
    cook, img_root = lvis_cooked
    ds = lvis.DatasetLVIS(str(cook), str(img_root), canvas=64, marker="sp12")
    ref = list(j_lvis.DatasetLVIS(str(cook), str(img_root), canvas=64,
                                  marker="sp12").batches(4, shuffle=True, seed=7))
    per_rank = [list(ds.batches(4, shuffle=True, seed=7, rank=r, world=world))
                for r in range(world)]
    assert all(len(p) == len(ref) == 3 for p in per_rank)
    for step, want in enumerate(ref):
        blocks = [p[step] for p in per_rank]
        assert all(b["img_data"].shape[0] == 4 // world for b in blocks)
        got = {k: np.concatenate([b[k] for b in blocks]) for k in want}
        assert_same(got, want, f"step {step}")
    with pytest.raises(ValueError):
        next(ds.batches(4, rank=0, world=3))


def test_cached_dataset_matches(lvis_cooked):
    cook, _ = lvis_cooked
    base = lvis.DatasetLVIS(str(cook), None, canvas=64, marker="sp12")
    ours, ref = loader.CachedDataset(base), j_loader.CachedDataset(base)
    assert isinstance(ours, loader.AbstractDataset) and len(ours) == len(ref)
    for i in (3, 0, 3):
        assert_same(ours[i], ref[i])
    assert ours[3] is ours[3] and sorted(ours._cache) == [0, 3]


# ------------------------------------------------------------- Cityscapes

def city_fixture(root, frames=True):
    """Two gtFine frames (60x120) of polygon jsons, with leftImg8bit PNGs."""
    gt = root / "gtFine" / "train" / "city"
    gt.mkdir(parents=True)
    rng = np.random.default_rng(1)
    objs_of = {
        "city_000000_000019": [
            {"label": "car", "polygon": [[20, 20], [80, 20], [80, 50], [20, 50]]},
            {"label": "sky", "polygon": [[0, 0], [119, 0], [119, 9], [0, 9]]},
            {"label": "person", "polygon": [[40, 10], [70, 10], [70, 55], [40, 55]]},
            {"label": "road", "polygon": [[-5, 50], [119, 50], [119, 59], [0, 59]]},
        ],
        "city_000001_000019": [
            {"label": "bus", "polygon": [[5, 5], [60, 5], [60, 40], [5, 40]]},
            {"label": "rider", "polygon": [[50, 30], [90, 25], [100, 58], [55, 58]]},
            {"label": "license plate", "polygon": [[10, 30], [20, 30], [20, 35]]},
            {"label": "ego vehicle", "polygon": [[0, 55], [119, 55], [119, 59]]},
        ],
    }
    for key, objs in objs_of.items():
        (gt / f"{key}_gtFine_polygons.json").write_text(
            json.dumps({"imgHeight": 60, "imgWidth": 120, "objects": objs}))
    img_dir = root / "leftImg8bit" / "train" / "city"
    img_dir.mkdir(parents=True)
    if frames:
        for key in objs_of:
            arr = rng.integers(0, 256, (30, 60, 3), dtype=np.uint8)  # resized to 60x120
            Image.fromarray(arr).save(img_dir / f"{key}_leftImg8bit.png")
    return str(root / "gtFine" / "train"), str(root / "leftImg8bit" / "train")


def cook_city(mod, tmp, name, how, frames):
    d = tmp / name
    d.mkdir()
    gtfine, images = city_fixture(d, frames)
    pre = mod.PreprocessCityscapes(gtfine, str(d / "cook"), image_dir=images,
                                   canvas_hw=(60, 120), crop_hw=(32, 64), seed=3)
    written = pre.make_N_samples(25, marker="m25") if how == "n" else pre.cook(marker="all")
    return d / "cook", written


@pytest.mark.parametrize("how,frames", [("n", True), ("all", False)])
def test_cityscapes_cooked_tree_byte_equal(tmp_path, how, frames):
    c1, w1 = cook_city(cityscapes, tmp_path, "port", how, frames)
    c2, w2 = cook_city(j_city, tmp_path, "jax", how, frames)
    assert w1 == w2 and len(w1) > 3
    assert_same_tree(c1, c2)


def test_cityscapes_helpers_equal():
    objs = json.loads(json.dumps([
        {"label": "car", "polygon": [[20, 20], [80, 20], [80, 50], [20, 50]]},
        {"label": "person", "polygon": [[40, 10], [70, 10], [70, 55], [-40, 55]]},
    ]))
    assert_same(cityscapes.object_index_map(objs, 60, 120),
                j_city.object_index_map(objs, 60, 120))
    assert_same(cityscapes.polygon_mask(objs[1]["polygon"], 60, 120),
                j_city.polygon_mask(objs[1]["polygon"], 60, 120))
    for pt in ((50, 30), (25, 30), (110, 5), (40, 10)):
        assert cityscapes.find_polygon(objs, pt) == j_city.find_polygon(objs, pt)
        assert (cityscapes.point_in_polygon(objs[0]["polygon"], pt)
                == j_city.point_in_polygon(objs[0]["polygon"], pt))
    assert cityscapes.IDX2LABEL == j_city.IDX2LABEL
    assert cityscapes.MAKE_SAMPLE_LABELS == j_city.MAKE_SAMPLE_LABELS
    assert [cityscapes.convert_index(i) for i in range(42)] == [
        j_city.convert_index(i) for i in range(42)]
    assert cityscapes.wrap_name("traffic light") == j_city.wrap_name("traffic light")
    assert cityscapes._stable_seed("city-000000") == j_city._stable_seed("city-000000")


@pytest.mark.parametrize("world", [1, 2])
def test_cityscapes_reader_items_batches_and_blocks(tmp_path, world):
    cook, _ = cook_city(j_city, tmp_path, "c", "n", True)
    # one sample without its frame file: the seeded fallback texture
    xs = sorted(p for p in os.listdir(cook / "m25") if p.endswith(".X.npy"))
    os.remove(cook / "m25" / xs[0])
    ds, ref = cityscapes.DatasetCityscapes(str(cook), "m25"), j_city.DatasetCityscapes(str(cook),
                                                                                       "m25")
    assert ds.names == ref.names and len(ds) > 3
    for i in range(len(ds)):
        assert_same(ds[i], ref[i], f"item {i}")
    want = list(ref.batches(2, shuffle=True, seed=2))
    blocks = [list(ds.batches(2, shuffle=True, seed=2, rank=r, world=world))
              for r in range(world)]
    for step, w in enumerate(want):
        got = {k: np.concatenate([b[step][k] for b in blocks]) for k in w}
        assert_same(got, w, f"step {step}")


def test_cityscapes_rgb_label_cooker_and_reader(tmp_path):
    def run(mod, name):
        d = tmp_path / name
        xd, yd = d / "x" / "city", d / "y" / "city"
        xd.mkdir(parents=True)
        yd.mkdir(parents=True)
        rng = np.random.default_rng(4)
        for k in range(3):
            key = f"city_00000{k}_000019"
            Image.fromarray(rng.integers(0, 256, (20, 36, 3), dtype=np.uint8)).save(
                xd / f"{key}_leftImg8bit.png")
            colors = [c for _, _, c in j_city.RGBLABEL_ROWS] + [(7, 7, 7)]
            lab = np.asarray(colors, np.uint8)[rng.integers(0, len(colors), (20, 36))]
            Image.fromarray(lab).save(yd / f"{key}_gtFine_color.png")
        pre = mod.PreprocessCityscapesRGBLabel(str(d / "x"), str(d / "y"), str(d / "cook"),
                                               crop_hw=(16, 24))
        return d / "cook", pre.cook()

    c1, w1 = run(cityscapes, "port")
    c2, w2 = run(j_city, "jax")
    assert w1 == w2 and len(w1) == 3
    assert_same_tree(c1, c2)
    ds, ref = cityscapes.DatasetCityscapesRGBLabel(str(c1)), j_city.DatasetCityscapesRGBLabel(str(c1))
    assert ds.NUM_CLASS == ref.NUM_CLASS == 20
    for i in range(len(ds)):
        assert_same(ds[i], ref[i])
    lab = np.asarray(Image.open(next((tmp_path / "port" / "y" / "city").iterdir())))
    assert_same(cityscapes.decode_rgb_label(lab), j_city.decode_rgb_label(lab))


# ------------------------------------------------------------------- Aria

def test_aria_summary_and_reader(tmp_path):
    cache = tmp_path / "cache"
    cache.mkdir()
    rng = np.random.default_rng(6)
    infos = [dict(fid=[i], ts=[1000 + i, 7], cat="chair", gz=[4 + i, 9], sp=[3, 24, 32])
             for i in range(3)]
    for i, info in enumerate(infos):
        name = aria_adt.info2fname(info)
        assert name == j_aria.info2fname(info)
        Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
            cache / f"{name}.png")
        if i != 1:  # one frame without its mask sidecar
            np.save(cache / f"{name}.Y.npy", (rng.uniform(size=(24, 32)) > 0.5).astype(np.uint8))
        assert aria_adt.fname2info(name + ".png") == j_aria.fname2info(name + ".png") == info
    (cache / "notes.txt").write_text("not a sample")
    rows = aria_adt.make_cache_summary(str(cache), str(tmp_path / "port.json"))
    ref_rows = j_aria.make_cache_summary(str(cache), str(tmp_path / "jax.json"))
    assert rows == ref_rows and len(rows) == 3
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    ds = aria_adt.DatasetAriaADT(str(cache))  # writes cache/smry.json itself
    ref = j_aria.DatasetAriaADT(str(cache), str(tmp_path / "jax.json"))
    assert len(ds) == len(ref) == 3
    for i in range(3):
        assert_same(ds[i], ref[i], f"item {i}")
    with pytest.raises(ImportError, match="projectaria_tools"):
        aria_adt.extract_timestamps_us("x.mp4")


# ------------------------------------------------------------------- ODGT

@pytest.fixture(scope="module")
def odgt_root(tmp_path_factory):
    """Six records (h > w and h <= w, one odd size) with 1-based labels
    1..4 and some 0 (ignore); record 2 is rich in the last class."""
    root = tmp_path_factory.mktemp("odgt")
    rng = np.random.default_rng(11)
    recs = []
    for i, (h, w) in enumerate([(48, 64), (64, 48), (40, 40), (37, 53), (64, 64), (50, 30)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"im{i}.jpg")
        seg = rng.integers(0, 5, (h, w)).astype(np.uint8)
        if i == 2:
            seg[:, : w * 2 // 3] = 4
        Image.fromarray(seg).save(root / f"seg{i}.png")
        recs.append({"fpath_img": f"im{i}.jpg", "fpath_segm": f"seg{i}.png",
                     "width": w, "height": h})
    (root / "list.odgt").write_text("\n".join(json.dumps(r) for r in recs))
    return root


def _pair(cls_name, root, **kw):
    args = dict(root_dataset=str(root), odgt=str(root / "list.odgt"), list_train="ADE_train",
                num_class=5, imgSizes=(32, 48), imgMaxSize=64, padding_constant=8,
                segm_downsampling_rate=1)
    args.update(kw)
    return getattr(odgt, cls_name)(**args), getattr(j_odgt, cls_name)(**args)


def test_odgt_helpers_equal(tmp_path):
    for s in ("ADE", "cityscapes_x", "GLEASON", "Digest", "histo", "DeepGlob"):
        assert odgt.detect_family(s, "") == j_odgt.detect_family(s, "")
        fam = odgt.detect_family(s, "")
        for cm, bc in ((0, -1), (3, -1), (0, 7)):
            assert odgt.family_label_mapping(fam, cm, bc) == j_odgt.family_label_mapping(fam, cm,
                                                                                        bc)
    for x, p in ((33, 8), (32, 8), (1, 32), (1000, 32)):
        assert odgt.round2nearest_multiple(x, p) == j_odgt.round2nearest_multiple(x, p)
    recs = [{"a": i} for i in range(6)]
    assert odgt.parse_odgt(recs, 4, 1, 3) == j_odgt.parse_odgt(recs, 4, 1, 3)
    with pytest.raises(AssertionError):
        odgt.parse_odgt([])
    from fovealseg_torch.configs import get_default_cfg

    cfg = get_default_cfg()
    cfg.DATASET.mirror_padding = True
    assert odgt.warn_dead_options(cfg) == j_odgt.warn_dead_options(cfg) == ["mirror_padding"]


@pytest.mark.parametrize("mode", ["Flip", "Flip_Pixel", "cityHRaug", "balance_sample",
                                  "fullFoV_balance_sample", "Crop_Flip", "Crop_aug_24",
                                  "Crop_noaug_24", "none"])
def test_odgt_train_batches_equal(odgt_root, mode):
    """The augmentation family, the aspect-ratio groups, the pyramid choice
    and the segm downsampling: every batch bit-equal."""
    ours, ref = _pair("TrainDataset", odgt_root, random_flip=mode, segm_downsampling_rate=4)
    got, want = list(ours.batches(2, seed=3)), list(ref.batches(2, seed=3))
    assert len(want) >= 2
    assert_same(got, want, mode)


@pytest.mark.parametrize("kw", [dict(repeat_sample=2),
                                dict(num_class=2, gt_gradient_rm_under_repre=0.3),
                                dict(list_train="cityscapes_train", binary_class=3)],
                         ids=["repeat", "under_repre", "cityscapes_binary"])
def test_odgt_sample_filters_equal(odgt_root, kw):
    ours, ref = _pair("TrainDataset", odgt_root, **kw)
    assert_same(list(ours.batches(2, seed=1)), list(ref.batches(2, seed=1)))


@pytest.mark.parametrize("kw", [dict(), dict(val_central_crop=True, val_central_crop_shape=(24, 20)),
                                dict(expand_prediection_rate=1.5, imgSizes=(30, 45),
                                     padding_constant=32)],
                         ids=["pyramid", "central_crop", "expand_rate"])
def test_odgt_val_records_equal(odgt_root, kw):
    ours, ref = _pair("ValDataset", odgt_root, **kw)
    for i in range(len(ref)):
        assert_same(ours[i], ref[i], f"record {i}")


def test_odgt_test_patch_walk_equal(odgt_root):
    ours, ref = _pair("TestDataset", odgt_root, list_train="gleason2019_train268_24_x")
    assert ours._patch_size() == 24
    for i in range(len(ref)):
        assert_same(ours[i], ref[i], f"record {i}")
