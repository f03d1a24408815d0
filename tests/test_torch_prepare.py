"""The port's dataset preparation (``iic_tpu_torch/data/prepare.py``)
against the JAX package's (``iic_tpu/data/prepare.py``), on tiny raw trees
written here: Potsdam RGBIR tiles whose sides are not multiples of the
patch side, one with a label tile in the six ISPRS colours and one colour
off the palette, one without; COCO-Stuff-164k annotation pngs with the
unlabelled value 255 and allowed-class shares on both sides of
``min_fraction``, 0.75 exactly included. The output trees must be equal:
the same file names, the .mat arrays equal through ``loadmat`` (savemat's
header holds a timestamp) and the lists byte for byte; the port's Potsdam
reader must read its tree as the JAX reader does."""

import filecmp
import os
import pickle
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from iic_tpu.data import prepare as jprep
from iic_tpu.data import seg_datasets as jsd
from iic_tpu_torch.data import prepare as tprep
from iic_tpu_torch.data import seg_datasets as tsd

cv2 = pytest.importorskip("cv2")

PATCH = 20
# (name, (h, w), labelled): edges of 5 and 10 rows / columns are dropped
TILES = [("top_potsdam_2_10_RGBIR.tif", (65, 90), True),
         ("top_potsdam_2_11_RGBIR.tif", (50, 41), False)]
OFF_PALETTE = (10, 20, 30)
LISTS = ("unlabelled_train.txt", "labelled_train.txt", "labelled_test.txt",
         "debugged.out")


def _write_potsdam_raw(raw, rng, subdir=True):
    tiles = os.path.join(raw, "4_Ortho_RGBIR") if subdir else raw
    os.makedirs(tiles, exist_ok=True)
    os.makedirs(os.path.join(raw, "5_Labels_all"), exist_ok=True)
    palette = np.array(list(tprep._POTSDAM_COLORS) + [OFF_PALETTE],
                       np.uint8)
    for name, (h, w), labelled in TILES:
        assert cv2.imwrite(os.path.join(tiles, name), rng.integers(
            0, 256, (h, w, 4), dtype=np.uint8))
        if labelled:
            rgb = palette[rng.integers(0, len(palette), (h, w))]
            assert cv2.imwrite(
                os.path.join(raw, "5_Labels_all",
                             name.replace("RGBIR", "label")),
                np.ascontiguousarray(rgb[..., ::-1]))


def _assert_trees_equal(ours, theirs):
    import scipy.io as sio

    for sub, key in (("imgs", "img"), ("gt", "gt")):
        names = sorted(os.listdir(os.path.join(ours, sub)))
        assert names == sorted(os.listdir(os.path.join(theirs, sub)))
        for name in names:
            got = sio.loadmat(os.path.join(ours, sub, name))[key]
            want = sio.loadmat(os.path.join(theirs, sub, name))[key]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for name in LISTS:
        assert filecmp.cmp(os.path.join(ours, name),
                           os.path.join(theirs, name), shallow=False), name


@pytest.mark.parametrize("subdir", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_potsdam_prepare_equals_jax(tmp_path, subdir, seed):
    raw = str(tmp_path / "raw")
    _write_potsdam_raw(raw, np.random.default_rng(seed), subdir)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    counts = tprep.potsdam_prepare(raw, ours, patch_side=PATCH, seed=seed)
    assert counts == jprep.potsdam_prepare(raw, theirs, patch_side=PATCH,
                                           seed=seed)
    # 3 x 4 labelled patches (one fifth of them test), 2 x 2 unlabelled
    assert counts == (4, 10, 2)
    _assert_trees_equal(ours, theirs)
    assert len(os.listdir(os.path.join(ours, "imgs"))) == 16
    assert len(os.listdir(os.path.join(ours, "gt"))) == 12


def test_potsdam_labels_map_the_palette(tmp_path):
    """Each ISPRS colour maps to its class and a colour off the palette to
    clutter (5), as in JAX; the patches keep the tiles' rows and columns."""
    import scipy.io as sio

    assert tprep._POTSDAM_COLORS == jprep._POTSDAM_COLORS
    rng = np.random.default_rng(1)
    colours = np.array(list(tprep._POTSDAM_COLORS) + [OFF_PALETTE],
                       np.uint8)
    bgr = np.ascontiguousarray(colours[rng.integers(0, 7, (9, 11))][..., ::-1])
    got = tprep._potsdam_rgb_to_class(bgr)
    np.testing.assert_array_equal(got, jprep._potsdam_rgb_to_class(bgr))
    assert got.dtype == np.int32 and set(np.unique(got)) == set(range(6))
    off = (bgr[..., ::-1] == OFF_PALETTE).all(-1)
    assert off.any() and (got[off] == 5).all()

    raw = str(tmp_path / "raw")
    _write_potsdam_raw(raw, rng)
    out = str(tmp_path / "out")
    tprep.potsdam_prepare(raw, out, patch_side=PATCH)
    tile = cv2.imread(os.path.join(raw, "4_Ortho_RGBIR", TILES[0][0]),
                      cv2.IMREAD_UNCHANGED)
    label = cv2.imread(os.path.join(raw, "5_Labels_all",
                                    TILES[0][0].replace("RGBIR", "label")),
                       cv2.IMREAD_COLOR)
    # patch 5 of the first tile: row 1, column 1
    img5 = sio.loadmat(os.path.join(out, "imgs", "5.mat"))["img"]
    np.testing.assert_array_equal(img5, tile[20:40, 20:40])
    gt5 = sio.loadmat(os.path.join(out, "gt", "5.mat"))["gt"]
    np.testing.assert_array_equal(
        gt5, tprep._potsdam_rgb_to_class(label[20:40, 20:40]))


@pytest.mark.parametrize("coarse", [True, False])
def test_port_reader_reads_the_prepared_tree(tmp_path, coarse):
    raw = str(tmp_path / "raw")
    _write_potsdam_raw(raw, np.random.default_rng(2))
    out = str(tmp_path / "out")
    tprep.potsdam_prepare(raw, out, patch_side=PATCH)
    cfg = SimpleNamespace(
        dataset="Potsdam", dataset_root=out, gt_k=3 if coarse else 6,
        use_coarse_labels=coarse, input_sz=16, pre_scale_all=False,
        pre_scale_factor=0.5, use_random_scale=False, scale_min=0.6,
        scale_max=1.4)
    for split, n in (("unlabelled_train", 4), ("labelled_train", 10),
                     ("labelled_test", 2)):
        ours = tsd.build_seg_dataset(cfg, split, "train")
        theirs = jsd.build_seg_dataset(cfg, split, "train")
        assert len(ours) == len(theirs) == n
        for i in range(n):
            got = ours.get_train(i, np.random.default_rng(i))
            want = theirs.get_train(i, np.random.default_rng(i))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert got[0].shape == (16, 16, 4)
        if split != "unlabelled_train":
            for i in range(n):
                img, label, mask = ours.get_test(i)
                for g, w in zip((img, label, mask), theirs.get_test(i)):
                    np.testing.assert_array_equal(g, w)
                assert label.max() <= (2 if coarse else 5)


# ------------------------------------------------------------- COCO-164k

ALLOWED = ("ground-stuff", "plant-stuff", "sky-stuff")
SIDE = 4  # 16 pixels an annotation
# (id, allowed pixels, 255 pixels): shares 1, 0.75, 11/16, 0.75 with 255,
# 10/16 with 255, none
ANNOTATIONS = [("000001", 16, 0), ("000002", 12, 0), ("000003", 11, 0),
               ("000004", 12, 4), ("000005", 10, 6), ("000006", 0, 16)]
F2C = np.array([f % 27 for f in range(182)], np.int32)


def _write_coco(root, split, rng):
    os.makedirs(os.path.join(root, "annotations", split))
    allowed = [tsd.COARSE_NAME_TO_INDEX[n] for n in ALLOWED]  # fine == coarse
    other = [f for f in range(27) if f not in allowed]
    for image_id, n_allowed, n_unlabelled in ANNOTATIONS:
        label = np.concatenate([
            rng.choice(allowed, n_allowed),
            np.full(n_unlabelled, 255),
            rng.choice(other, SIDE * SIDE - n_allowed - n_unlabelled)])
        label = rng.permutation(label).astype(np.uint8).reshape(SIDE, SIDE)
        assert cv2.imwrite(os.path.join(root, "annotations", split,
                                        image_id + ".png"), label)
    with open(os.path.join(root, "fine_to_coarse_dict.pickle"), "wb") as f:
        pickle.dump({"fine_index_to_coarse_index":
                     {i: int(c) for i, c in enumerate(F2C)}}, f)


@pytest.mark.parametrize("min_fraction,kept", [
    (0.75, ["000001", "000002", "000004"]),
    (0.5, ["000001", "000002", "000003", "000004", "000005"])])
@pytest.mark.parametrize("source", ["explicit", "loaded"])
def test_coco164k_curate_equals_jax(tmp_path, source, min_fraction, kept):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    _write_coco(ours, "train2017", np.random.default_rng(0))
    shutil.copytree(ours, theirs)
    f2c = F2C if source == "explicit" else None
    n = tprep.coco164k_curate(ours, "train2017", ALLOWED, 6,
                              min_fraction=min_fraction, fine_to_coarse=f2c)
    assert n == jprep.coco164k_curate(theirs, "train2017", ALLOWED, 6,
                                      min_fraction=min_fraction,
                                      fine_to_coarse=f2c)
    path = os.path.join("curated", "train2017", "curated_6.txt")
    assert filecmp.cmp(os.path.join(ours, path), os.path.join(theirs, path),
                       shallow=False)
    with open(os.path.join(ours, path)) as f:
        assert f.read().split() == kept
    assert n == len(kept)


def test_curated_list_names_and_empty_list(tmp_path):
    """``out_name`` names the list; a list with no id is an empty file, in
    both packages."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    _write_coco(ours, "val2017", np.random.default_rng(1))
    shutil.copytree(ours, theirs)
    for root, fn in ((ours, tprep), (theirs, jprep)):
        assert fn.coco164k_curate(root, "val2017", ALLOWED, 7,
                                  min_fraction=1.01, out_name="none") == 0
    path = os.path.join("curated", "val2017", "none.txt")
    assert os.path.getsize(os.path.join(ours, path)) == 0
    assert filecmp.cmp(os.path.join(ours, path), os.path.join(theirs, path),
                       shallow=False)


def test_missing_opencv_is_named(tmp_path, monkeypatch):
    """Without cv2 both functions raise an ImportError naming it (the JAX
    potsdam_prepare fails later, on None)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"potsdam_prepare needs OpenCV"):
        tprep.potsdam_prepare(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(ImportError, match=r"coco164k_curate needs OpenCV"):
        tprep.coco164k_curate(str(tmp_path), "train2017", ALLOWED, 6,
                              fine_to_coarse=F2C)
