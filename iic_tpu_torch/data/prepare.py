"""Dataset preparation (``iic_tpu/data/prepare.py``), host only: numpy,
``scipy.io`` and OpenCV, no torch.

``potsdam_prepare``: cut the ISPRS Potsdam RGBIR tiles into
``patch_side`` x ``patch_side`` .mat patches and write the
unlabelled_train / labelled_train / labelled_test split lists that the
Potsdam reader (``data/seg_datasets.py``) parses.

``coco164k_curate``: write the curated COCO-Stuff-164k list of the
annotation ids whose share of allowed coarse-class pixels is at least
``min_fraction``.

Both decode with OpenCV, imported inside them: where it is missing they
raise an ``ImportError`` that names it (the JAX function crashes later
instead), with no other decoder in its place.
"""

import os
import os.path as osp
from glob import glob

import numpy as np


def _cv2(caller):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{caller} needs OpenCV (cv2) to decode its "
                          "images, and it is not installed") from e
    return cv2


def potsdam_prepare(raw_root, out_root, patch_side=200,
                    unlabelled_frac=0.8, seed=0):
    """Cut the RGBIR tiles (``<raw_root>/4_Ortho_RGBIR/*.tif``, else
    ``<raw_root>/*.tif``) and their label tiles
    (``<raw_root>/5_Labels_all/<name with RGBIR -> label>``, where present)
    into whole patch_side^2 patches in row-major order, the edges that do
    not fill a patch dropped: imgs/<id>.mat ("img", uint8), gt/<id>.mat
    ("gt", int32 class ids) for the labelled ones. The labelled ids are
    shuffled by ``np.random.default_rng(seed)``; the first fifth (at least
    one) is labelled_test, the rest labelled_train, and the unlabelled ids
    are unlabelled_train. Also writes the reader's ``debugged.out`` marker.
    ``unlabelled_frac`` is accepted and unused, as in the JAX function.
    Returns (unlabelled, train, test) counts."""
    import scipy.io as sio

    cv2 = _cv2("potsdam_prepare")
    os.makedirs(osp.join(out_root, "imgs"), exist_ok=True)
    os.makedirs(osp.join(out_root, "gt"), exist_ok=True)

    tile_paths = sorted(glob(osp.join(raw_root, "4_Ortho_RGBIR", "*.tif")))
    if not tile_paths:
        tile_paths = sorted(glob(osp.join(raw_root, "*.tif")))
    assert tile_paths, f"no .tif tiles under {raw_root}"

    ids_labelled, ids_unlabelled = [], []
    next_id = 0
    for tile_path in tile_paths:
        img = cv2.imread(tile_path, cv2.IMREAD_UNCHANGED)
        assert img is not None, tile_path
        # the ISPRS release's label naming (the JAX function's second
        # replace, ".tif" -> ".tif", changes nothing and is left out)
        base = osp.basename(tile_path).replace("RGBIR", "label")
        label_path = osp.join(raw_root, "5_Labels_all", base)
        label = cv2.imread(label_path, cv2.IMREAD_COLOR) \
            if osp.exists(label_path) else None

        h, w = img.shape[:2]
        for y in range(0, h - patch_side + 1, patch_side):
            for x in range(0, w - patch_side + 1, patch_side):
                pid = str(next_id)
                next_id += 1
                patch = img[y:y + patch_side, x:x + patch_side]
                sio.savemat(osp.join(out_root, "imgs", pid + ".mat"),
                            {"img": patch.astype(np.uint8)})
                if label is not None:
                    gt = _potsdam_rgb_to_class(
                        label[y:y + patch_side, x:x + patch_side])
                    sio.savemat(osp.join(out_root, "gt", pid + ".mat"),
                                {"gt": gt.astype(np.int32)})
                    ids_labelled.append(pid)
                else:
                    ids_unlabelled.append(pid)

    np.random.default_rng(seed).shuffle(ids_labelled)
    n_test = max(len(ids_labelled) // 5, 1)
    test_ids = ids_labelled[:n_test]
    train_ids = ids_labelled[n_test:]

    for name, ids in (("unlabelled_train", ids_unlabelled),
                      ("labelled_train", train_ids),
                      ("labelled_test", test_ids)):
        _write_list(osp.join(out_root, name + ".txt"), ids)
    with open(osp.join(out_root, "debugged.out"), "w") as f:
        f.write("ok\n")
    return len(ids_unlabelled), len(train_ids), len(test_ids)


# ISPRS Potsdam label colours (RGB) -> the 6 fine classes (0 roads,
# 1 buildings, 2 vegetation, 3 trees, 4 cars, 5 clutter)
_POTSDAM_COLORS = {
    (255, 255, 255): 0,  # impervious surfaces / roads
    (0, 0, 255): 1,      # buildings
    (0, 255, 255): 2,    # low vegetation
    (0, 255, 0): 3,      # trees
    (255, 255, 0): 4,    # cars
    (255, 0, 0): 5,      # clutter
}


def _potsdam_rgb_to_class(gt_bgr):
    """(h, w, 3) BGR label tile -> (h, w) int32 classes; a colour off the
    palette is clutter (5)."""
    gt = np.full(gt_bgr.shape[:2], 5, np.int32)
    rgb = gt_bgr[:, :, ::-1]
    for colour, cls in _POTSDAM_COLORS.items():
        gt[(rgb == colour).all(axis=-1)] = cls
    return gt


def coco164k_curate(root, split, label_names_coarse, version,
                    min_fraction=0.75, out_name=None, fine_to_coarse=None):
    """Write ``<root>/curated/<split>/<out_name>.txt`` (by default
    ``curated_<version>``): the ids of ``<root>/annotations/<split>/*.png``
    in sorted order whose share of pixels in the coarse classes
    ``label_names_coarse`` is at least ``min_fraction`` (255, unlabelled,
    counts as in none). ``fine_to_coarse`` defaults to the root's map
    (``load_fine_to_coarse``). Returns the number of ids kept."""
    from iic_tpu_torch.data.seg_datasets import (
        COARSE_NAME_TO_INDEX, load_fine_to_coarse)

    cv2 = _cv2("coco164k_curate")
    if fine_to_coarse is None:
        fine_to_coarse = load_fine_to_coarse(root)
    allowed = {COARSE_NAME_TO_INDEX[n] for n in label_names_coarse}
    table = np.concatenate([[-1], fine_to_coarse])

    kept = []
    for p in sorted(glob(osp.join(root, "annotations", split, "*.png"))):
        label = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.int32)
        label[label == 255] = -1
        frac = np.isin(table[label + 1], list(allowed)).mean()
        if frac >= min_fraction:
            kept.append(osp.basename(p)[:-len(".png")])

    out_dir = osp.join(root, "curated", split)
    os.makedirs(out_dir, exist_ok=True)
    _write_list(osp.join(out_dir, (out_name or f"curated_{version}")
                         + ".txt"), kept)
    return len(kept)


def _write_list(path, ids):
    """One id a line, a final newline when there is any."""
    with open(path, "w") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
