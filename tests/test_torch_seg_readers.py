"""The port's COCO-Stuff and Potsdam readers against the JAX package's, on
fixture trees written here in the on-disk layouts the readers parse:
Coco10k (images/*.jpg, annotations/*.mat with "S", imageLists/), Coco164k
(images/<split>/*.jpg, annotations/<split>/*.png, curated/<split>/*.txt),
both sources of the fine -> coarse map (the pickle, and the raw txt + yaml
pair) and Potsdam (imgs/*.mat, gt/*.mat for labelled tiles only, the split
lists). Every COCO class in every label space it admits, and Potsdam coarse
and fine, each with no rescale, with ``pre_scale_all`` and with
``use_random_scale``: equal file lists and label tables, and bit-equal
``get_train`` (under equal rng seeds) and ``get_test``."""

import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from iic_tpu.data import seg_datasets as jsd
from iic_tpu_torch.data import seg_datasets as tsd

IDS = 5  # images a split
SIZES = [(50, 60), (44, 52), (64, 48), (40, 40), (58, 45)]


def _fine_to_coarse():
    return {f: f % 27 for f in range(182)}


def _write_coco(root, rng):
    import cv2
    import scipy.io as sio

    with open(os.path.join(root, "fine_to_coarse_dict.pickle"), "wb") as f:
        pickle.dump({"fine_index_to_coarse_index": _fine_to_coarse()}, f)
    # Coco10k: "S" holds 1-based fine labels, 0 unlabelled
    for sub in ("images", "annotations", "imageLists"):
        os.makedirs(os.path.join(root, "10k", sub))
    ids10 = [f"c10_{i}" for i in range(IDS)]
    for image_id, (h, w) in zip(ids10, SIZES):
        assert cv2.imwrite(os.path.join(root, "10k", "images",
                                        image_id + ".jpg"),
                           rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        sio.savemat(os.path.join(root, "10k", "annotations",
                                 image_id + ".mat"),
                    {"S": rng.integers(0, 183, (h, w)).astype(np.uint16)})
    for split, ids in (("train", ids10[:3]), ("test", ids10[3:]),
                       ("all", ids10)):
        with open(os.path.join(root, "10k", "imageLists", split + ".txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, "10k", "fine_to_coarse_dict.pickle"),
              "wb") as f:
        pickle.dump({"fine_index_to_coarse_index": _fine_to_coarse()}, f)
    # Coco164k: png fine labels, 255 unlabelled; curated id lists
    for split in ("train2017", "val2017"):
        for sub in ("images", "annotations", "curated"):
            os.makedirs(os.path.join(root, sub, split))
        ids = [f"{split}_{i:06d}" for i in range(IDS)]
        for image_id, (h, w) in zip(ids, SIZES):
            assert cv2.imwrite(
                os.path.join(root, "images", split, image_id + ".jpg"),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            label = rng.integers(0, 182, (h, w)).astype(np.uint8)
            label[rng.random((h, w)) < 0.1] = 255
            assert cv2.imwrite(
                os.path.join(root, "annotations", split, image_id + ".png"),
                label)
        for name in ("Coco164kFew_Stuff_6", "Coco164kFew_Stuff_People_6",
                     "Coco164kFew_Stuff_Animals_6",
                     "Coco164kFew_Stuff_People_Animals_6",
                     "Coco164kFull_Stuff_Coarse_7"):
            keep = sorted(rng.choice(IDS, 3, replace=False))
            with open(os.path.join(root, "curated", split, name + ".txt"),
                      "w") as f:
                f.write("\n".join(ids[i] for i in keep) + "\n")


def _write_potsdam(root, rng, sz=200):
    """imgs/<id>.mat {"img": uint8 (sz, sz, 4)}, gt/<id>.mat {"gt"} for the
    labelled tiles only (as the dataset's preparation writes them), and
    the three split lists."""
    import scipy.io as sio

    for sub in ("imgs", "gt"):
        os.makedirs(os.path.join(root, sub))
    splits = {"unlabelled_train": [f"u{i}" for i in range(4)],
              "labelled_train": [f"lt{i}" for i in range(3)],
              "labelled_test": [f"le{i}" for i in range(3)]}
    for split, ids in splits.items():
        for image_id in ids:
            sio.savemat(os.path.join(root, "imgs", image_id + ".mat"),
                        {"img": rng.integers(0, 256, (sz, sz, 4),
                                             dtype=np.uint8)})
            if split != "unlabelled_train":
                sio.savemat(os.path.join(root, "gt", image_id + ".mat"),
                            {"gt": rng.integers(0, 6, (sz, sz))
                             .astype(np.uint8)})
        with open(os.path.join(root, split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(0)
    coco = tmp_path_factory.mktemp("coco")
    _write_coco(str(coco), rng)
    potsdam = tmp_path_factory.mktemp("potsdam")
    _write_potsdam(str(potsdam), rng)
    return {"coco": str(coco), "potsdam": str(potsdam)}


SCALES = {"none": {},
          "pre_scale": dict(pre_scale_all=True, pre_scale_factor=0.7),
          "random_scale": dict(use_random_scale=True, scale_min=0.6,
                               scale_max=1.4)}


def _cfg(dataset, root, **kw):
    cfg = dict(dataset=dataset, dataset_root=root, gt_k=3,
               use_coarse_labels=True, include_things_labels=False,
               incl_animal_things=False, coco_164k_curated_version=6,
               fine_to_coarse_dict="", input_sz=40, pre_scale_all=False,
               pre_scale_factor=0.5, use_random_scale=False, scale_min=0.6,
               scale_max=1.4)
    cfg.update(kw)
    return SimpleNamespace(**cfg)


def _full_cases():
    # (use_coarse_labels, include_things_labels) -> gt_k
    return [(True, False, 15), (True, True, 27), (False, False, 91),
            (False, True, 182)]


def _few_cases():
    # (include_things_labels, incl_animal_things) -> gt_k
    return [(False, False, 3), (True, False, 4), (False, True, 4),
            (True, True, 5)]


COCO_CASES = (
    [("Coco10kFull", c, t, False, k) for c, t, k in _full_cases()]
    + [("Coco164kFull", c, t, False, k) for c, t, k in _full_cases()]
    + [("Coco164kCuratedFull", c, t, False, k) for c, t, k in _full_cases()
       if c]
    + [(name, True, t, a, k)
       for name in ("Coco10kFew", "Coco164kFew", "Coco164kCuratedFew")
       for t, a, k in _few_cases()])


def _split(dataset):
    return "train" if dataset.startswith("Coco10k") else "train2017"


def _root(trees, dataset):
    return os.path.join(trees["coco"], "10k") \
        if dataset.startswith("Coco10k") else trees["coco"]


def _assert_readers_equal(ours, theirs, test_ids):
    assert ours.files == theirs.files and len(ours) > 0
    t_ours, t_theirs = ours.label_filter_table(), theirs.label_filter_table()
    if t_theirs is None:
        assert t_ours is None
    else:
        np.testing.assert_array_equal(t_ours, t_theirs)
        assert t_ours.dtype == t_theirs.dtype
    rng_o, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(len(ours)):
        for a, b in zip(ours.get_train(i, rng_o), theirs.get_train(i, rng_t)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for i in test_ids:
        for a, b in zip(ours.get_test(i), theirs.get_test(i)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("dataset,coarse,things,animals,gt_k", COCO_CASES)
def test_coco_reader_matches_jax(trees, dataset, coarse, things, animals,
                                 gt_k, scale):
    version = 7 if dataset == "Coco164kCuratedFull" else 6
    cfg = _cfg(dataset, _root(trees, dataset), gt_k=gt_k,
               use_coarse_labels=coarse, include_things_labels=things,
               incl_animal_things=animals,
               coco_164k_curated_version=version, **SCALES[scale])
    ours = tsd.build_seg_dataset(cfg, _split(dataset), "train")
    theirs = jsd.build_seg_dataset(cfg, _split(dataset), "train")
    assert type(ours).__name__ == type(theirs).__name__ == dataset
    _assert_readers_equal(ours, theirs, range(len(ours)))
    # the table form is the per-pixel filter (the native path's contract)
    raw = np.arange(-1, 182, dtype=np.int32).reshape(1, -1)
    label, mask = ours._filter_label(raw)
    np.testing.assert_array_equal(np.where(mask, label, -1)[0],
                                  ours.label_filter_table())


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("coarse", [True, False])
def test_potsdam_reader_matches_jax(trees, coarse, scale):
    cfg = _cfg("Potsdam", trees["potsdam"], gt_k=3 if coarse else 6,
               use_coarse_labels=coarse, input_sz=160, **SCALES[scale])
    for split in ("unlabelled_train", "labelled_train", "labelled_test"):
        ours = tsd.build_seg_dataset(cfg, split, "train")
        theirs = jsd.build_seg_dataset(cfg, split, "train")
        labelled = split != "unlabelled_train"
        _assert_readers_equal(ours, theirs,
                              range(len(ours)) if labelled else [])
        if not labelled:
            with pytest.raises(ValueError, match="without ground truth"):
                ours.get_test(0)


@pytest.mark.parametrize("source", ["pickle", "txt+yaml"])
def test_fine_to_coarse_sources_match_jax(tmp_path, source):
    """Both sources of the map give the JAX package's array; the txt + yaml
    pair is a hierarchy of nested dicts with the coarse classes' lists of
    fine names at its leaves."""
    import yaml

    expect = np.array([_fine_to_coarse()[f] for f in range(182)], np.int32)
    if source == "pickle":
        with open(tmp_path / "fine_to_coarse_dict.pickle", "wb") as f:
            pickle.dump({"fine_index_to_coarse_index": _fine_to_coarse()}, f)
    else:
        with open(tmp_path / "cocostuff_fine_raw.txt", "w") as f:
            f.write("".join(f"{i}\tfine-{i}\n" for i in range(182)))
        names = tsd.SORTED_COARSE_NAMES
        tree = {"things": {}, "stuff": {}}
        for c, name in enumerate(names):
            fines = [f"fine-{i}" for i in range(182) if i % 27 == c]
            tree["things" if c < 12 else "stuff"][name] = fines
        with open(tmp_path / "cocostuff_hierarchy.yaml", "w") as f:
            yaml.safe_dump({"root": tree}, f)
    ours = tsd.load_fine_to_coarse(str(tmp_path))
    theirs = jsd.load_fine_to_coarse(str(tmp_path))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, expect)
    assert ours.dtype == theirs.dtype == np.int32
    assert tsd.SORTED_COARSE_NAMES == jsd.SORTED_COARSE_NAMES


def test_a_reader_without_opencv_names_itself(trees, monkeypatch):
    """Where cv2 is missing, a COCO reader raises ImportError naming
    itself; Potsdam without a rescale still reads its tiles (scipy only)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    coco = tsd.build_seg_dataset(_cfg("Coco164kFull", trees["coco"],
                                      gt_k=15), "train2017", "train")
    with pytest.raises(ImportError, match="Coco164kFull needs OpenCV"):
        coco.get_train(0, np.random.default_rng(0))
    cfg = _cfg("Potsdam", trees["potsdam"], input_sz=160)
    potsdam = tsd.build_seg_dataset(cfg, "labelled_test", "test")
    img, label, mask = potsdam.get_test(0)
    assert img.shape == (160, 160, 4) and label.max() <= 2
    scaled = tsd.build_seg_dataset(
        _cfg("Potsdam", trees["potsdam"], input_sz=160,
             pre_scale_all=True), "labelled_test", "test")
    with pytest.raises(ImportError, match="Potsdam needs OpenCV"):
        scaled.get_test(0)


def test_dispatch_covers_every_name(trees):
    assert set(tsd.SEG_DATASETS) == set(jsd.SEG_DATASETS)
    with pytest.raises(ValueError, match="unknown segmentation dataset"):
        tsd.build_seg_dataset(_cfg("Coco20k", trees["coco"]), "train",
                              "train")
