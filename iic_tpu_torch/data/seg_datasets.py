"""Segmentation dataset readers, host side (``iic_tpu/data/seg_datasets.py``).

The host does what needs per-image shapes: pre-scale, random scale,
pad-and-crop to input_sz, label filtering and masking. Everything after the
crop runs batched on the device (``data/seg_pipeline.py``).

Outputs per sample:
  train: (img uint8 (sz, sz, C_raw), mask uint8 (sz, sz))
  test:  (img uint8 (sz, sz, C_raw), label int32 (sz, sz), mask uint8)

C_raw = 3 for COCO-Stuff (bgr -> rgb), 4 for Potsdam (rgb + ir).

The readers: the COCO-Stuff family (10k and 164k layouts, full and few
label spaces, the curated lists), Potsdam (``.mat`` tiles) and the
synthetic sets. OpenCV (cv2) decodes COCO's ``.jpg`` / ``.png`` and does
every rescale; it is imported where it is used, and a reader that needs it
where it is missing raises ``ImportError`` naming the reader. Potsdam
without a rescale needs scipy only.
"""

import os.path as osp
import pickle
from glob import glob

import numpy as np

from iic_tpu_torch.data.seg_transforms import pad_and_or_crop

# The 27 coarse classes of COCO-Stuff, things first then stuff (the
# published hierarchy's order, which the fine -> coarse indices follow)
SORTED_COARSE_NAMES = [
    "electronic-things", "appliance-things", "food-things",
    "furniture-things", "indoor-things", "kitchen-things",
    "accessory-things", "animal-things", "outdoor-things",
    "person-things", "sports-things", "vehicle-things",
    "ceiling-stuff", "floor-stuff", "food-stuff", "furniture-stuff",
    "rawmaterial-stuff", "textile-stuff", "wall-stuff", "window-stuff",
    "building-stuff", "ground-stuff", "plant-stuff", "sky-stuff",
    "solid-stuff", "structural-stuff", "water-stuff",
]
COARSE_NAME_TO_INDEX = {n: i for i, n in enumerate(SORTED_COARSE_NAMES)}


def _cv2(reader):
    """OpenCV, or an ``ImportError`` that names the reader needing it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{reader} needs OpenCV (cv2) to decode or rescale "
                          "images, and it is not installed") from e
    return cv2


def generate_fine_to_coarse(fine_raw_txt, hierarchy_yaml):
    """The 182-entry fine -> coarse index map from the label list and the
    hierarchy file shipped with COCO-Stuff."""
    import yaml

    with open(fine_raw_txt) as f:
        pairs = [tuple(line.rstrip().split("\t")) for line in f]
        pairs = [(int(ind), name) for ind, name in pairs]

    with open(hierarchy_yaml) as f:
        d = yaml.safe_load(f)

    def find_parent(name, node):
        for k, v in node.items():
            if isinstance(v, list):
                if name in v:
                    yield k
            elif isinstance(v, dict):
                yield from find_parent(name, v)

    fine_to_coarse = np.full(182, -1, np.int32)
    for fine_ind, fine_name in pairs:
        parents = list(find_parent(fine_name, d))
        if len(parents) != 1:
            raise ValueError(f"{hierarchy_yaml}: {fine_name!r} has parents "
                             f"{parents}, expected one")
        fine_to_coarse[fine_ind] = COARSE_NAME_TO_INDEX[parents[0]]
    if (fine_to_coarse < 0).any():
        raise ValueError(f"{fine_raw_txt}: fine classes without a coarse "
                         f"parent: {np.flatnonzero(fine_to_coarse < 0)}")
    return fine_to_coarse


def load_fine_to_coarse(root, dict_path=""):
    """The fine -> coarse map: the pickle at ``dict_path``, else
    ``fine_to_coarse_dict.pickle`` in the dataset root, else generated from
    the root's raw txt + yaml."""
    candidates = [dict_path] if dict_path else []
    candidates += [osp.join(root, "fine_to_coarse_dict.pickle")]
    for p in candidates:
        if p and osp.exists(p):
            with open(p, "rb") as f:
                d = pickle.load(f)["fine_index_to_coarse_index"]
            arr = np.full(182, -1, np.int32)
            for k, v in d.items():
                arr[k] = v
            return arr
    txt = osp.join(root, "cocostuff_fine_raw.txt")
    yml = osp.join(root, "cocostuff_hierarchy.yaml")
    if osp.exists(txt) and osp.exists(yml):
        return generate_fine_to_coarse(txt, yml)
    raise FileNotFoundError(
        f"fine->coarse mapping not found under {root}; provide "
        "fine_to_coarse_dict.pickle or the raw txt+yaml files")


def _resize_pair(img, label, fx, cv2):
    img = cv2.resize(img, dsize=None, fx=fx, fy=fx,
                     interpolation=cv2.INTER_LINEAR)
    if label is not None:
        label = cv2.resize(label, dsize=None, fx=fx, fy=fx,
                           interpolation=cv2.INTER_NEAREST)
    return img, label


class _SegDatasetBase:
    """Common host prep: pre-scale / random scale / crop / label filter."""

    def __init__(self, config, split, purpose):
        self.config = config
        self.split = split
        self.purpose = purpose
        self.input_sz = config.input_sz
        self.gt_k = config.gt_k
        self.pre_scale_all = getattr(config, "pre_scale_all", False)
        self.pre_scale_factor = getattr(config, "pre_scale_factor", 0.5)
        self.use_random_scale = getattr(config, "use_random_scale", False)
        self.scale_min = getattr(config, "scale_min", 0.6)
        self.scale_max = getattr(config, "scale_max", 1.4)
        self.files = []

    def __len__(self):
        return len(self.files)

    def _load_raw(self, idx):
        raise NotImplementedError

    def _filter_label(self, label):
        """-> (new_label, mask bool)."""
        raise NotImplementedError

    def label_filter_table(self):
        """Lookup table over raw label + 1 -> filtered label (-1: masked
        out); None when the subclass has no table form."""
        return None

    def _rescale(self, img, label, fx):
        return _resize_pair(img, label, fx, _cv2(type(self).__name__))

    def get_train(self, idx, rng):
        """Host geometry of a train sample: (img uint8, mask uint8)."""
        img, label = self._load_raw(idx)
        img = img.astype(np.float32)
        if self.pre_scale_all:
            img, label = self._rescale(img, label, self.pre_scale_factor)
        if self.use_random_scale:
            fx = rng.random() * (self.scale_max - self.scale_min) \
                + self.scale_min
            img, label = self._rescale(img, label, fx)
        img, coords = pad_and_or_crop(img, self.input_sz, mode="random",
                                      rng=rng)
        if label is not None:
            label, _ = pad_and_or_crop(label, self.input_sz, mode="fixed",
                                       coords=coords)
            _, mask = self._filter_label(label)
        else:
            mask = np.ones((self.input_sz, self.input_sz), bool)
        return img.astype(np.uint8), mask.astype(np.uint8)

    def get_test(self, idx):
        """Host geometry of a mapping / eval sample: (img uint8, label
        int32, mask uint8)."""
        img, label = self._load_raw(idx)
        if label is None:
            raise ValueError(f"{type(self).__name__} sample {idx}: a test "
                             "sample without ground truth")
        img = img.astype(np.float32)
        if self.pre_scale_all:
            img, label = self._rescale(img, label, self.pre_scale_factor)
        img, _ = pad_and_or_crop(img, self.input_sz, mode="centre")
        label, _ = pad_and_or_crop(label, self.input_sz, mode="centre")
        label, mask = self._filter_label(label)
        return (img.astype(np.uint8), label.astype(np.int32),
                mask.astype(np.uint8))


# --------------------------------------------------------------- COCO-Stuff

class _CocoBase(_SegDatasetBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.root = config.dataset_root
        self.fine_to_coarse = load_fine_to_coarse(
            self.root, getattr(config, "fine_to_coarse_dict", ""))

    def _load_10k(self, image_id):
        cv2 = _cv2(type(self).__name__)
        import scipy.io as sio
        image = cv2.imread(
            osp.join(self.root, "images", image_id + ".jpg"),
            cv2.IMREAD_COLOR)[:, :, ::-1]  # BGR -> RGB
        label = sio.loadmat(
            osp.join(self.root, "annotations", image_id + ".mat")
        )["S"].astype(np.int32) - 1  # [-1, 181]
        return image.astype(np.uint8), label

    def _load_164k(self, image_id):
        cv2 = _cv2(type(self).__name__)
        image = cv2.imread(
            osp.join(self.root, "images", self.split, image_id + ".jpg"),
            cv2.IMREAD_COLOR)[:, :, ::-1]
        label = cv2.imread(
            osp.join(self.root, "annotations", self.split,
                     image_id + ".png"),
            cv2.IMREAD_GRAYSCALE).astype(np.int32)
        label[label == 255] = -1
        return image.astype(np.uint8), label


def _expect_gt_k(config, expected):
    if config.gt_k != expected:
        raise ValueError(f"{config.dataset}: this label space has "
                         f"{expected} classes, --gt_k is {config.gt_k}")


class _CocoFullMixin:
    """Full label space: coarse (27, or 15 without things) or fine (182, or
    91 without things)."""

    def init_label_space(self, config):
        self.use_coarse_labels = config.use_coarse_labels
        self.include_things_labels = getattr(
            config, "include_things_labels", False)
        if self.use_coarse_labels:
            expected = 27 if self.include_things_labels else 15
        else:
            expected = 182 if self.include_things_labels else 91
        _expect_gt_k(config, expected)
        self.first_allowed = 0 if self.include_things_labels else (
            12 if self.use_coarse_labels else 91)

    def _filter_label(self, label):
        if self.use_coarse_labels:
            # fine -> coarse; -1 stays -1 through the shifted table
            table = np.concatenate([[-1], self.fine_to_coarse])
            label = table[label + 1]
        mask = label >= self.first_allowed
        return label - self.first_allowed, mask

    def label_filter_table(self):
        raw = np.arange(-1, 182, dtype=np.int32)
        if self.use_coarse_labels:
            table = np.concatenate([[-1], self.fine_to_coarse])
            mapped = table[raw + 1]
        else:
            mapped = raw
        out = mapped - self.first_allowed
        out[mapped < self.first_allowed] = -1
        return out.astype(np.int32)


class _CocoFewMixin:
    """Few label space: sky, plant and ground stuff, with person and / or
    animal things."""

    def init_label_space(self, config):
        if not config.use_coarse_labels:
            raise ValueError(f"{config.dataset} needs --use_coarse_labels")
        self.include_things_labels = getattr(
            config, "include_things_labels", False)
        self.incl_animal_things = getattr(
            config, "incl_animal_things", False)
        label_names = ["sky-stuff", "plant-stuff", "ground-stuff"]
        if self.include_things_labels:
            label_names.append("person-things")
        if self.incl_animal_things:
            label_names.append("animal-things")
        _expect_gt_k(config, len(label_names))
        self.label_names = label_names
        allowed = [COARSE_NAME_TO_INDEX[n] for n in label_names]
        # fine -> few: -1 where the fine class's coarse parent is not kept
        fine_to_few = np.full(182, -1, np.int32)
        for c in range(182):
            coarse = self.fine_to_coarse[c]
            if coarse in allowed:
                fine_to_few[c] = allowed.index(coarse)
        self.fine_to_few = fine_to_few

    def _filter_label(self, label):
        table = np.concatenate([[-1], self.fine_to_few])
        new_label = table[label + 1]
        mask = new_label >= 0
        return new_label, mask

    def label_filter_table(self):
        return np.concatenate([[-1], self.fine_to_few]).astype(np.int32)


def _coco_10k_files(root, split):
    if split not in ("train", "test", "all"):
        raise ValueError(f"Coco10k split {split!r}")
    with open(osp.join(root, "imageLists", split + ".txt")) as f:
        return [line.rstrip() for line in f]


def _coco_164k_files(root, split):
    if split not in ("train2017", "val2017"):
        raise ValueError(f"Coco164k split {split!r}")
    fl = sorted(glob(osp.join(root, "images", split, "*.jpg")))
    return [osp.basename(f)[:-len(".jpg")] for f in fl]


def _coco_curated_files(root, split, name):
    with open(osp.join(root, "curated", split, name + ".txt")) as f:
        return [line.rstrip() for line in f]


def _curated_few_name(config):
    name = "Coco164kFew_Stuff"
    if getattr(config, "include_things_labels", False) and \
            getattr(config, "incl_animal_things", False):
        name += "_People_Animals"
    elif getattr(config, "include_things_labels", False):
        name += "_People"
    elif getattr(config, "incl_animal_things", False):
        name += "_Animals"
    return f"{name}_{config.coco_164k_curated_version}"


class Coco10kFull(_CocoFullMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.init_label_space(config)
        self.files = _coco_10k_files(self.root, split)

    def _load_raw(self, idx):
        return self._load_10k(self.files[idx])


class Coco10kFew(_CocoFewMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.init_label_space(config)
        self.files = _coco_10k_files(self.root, split)

    def _load_raw(self, idx):
        return self._load_10k(self.files[idx])


class Coco164kFull(_CocoFullMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.init_label_space(config)
        self.files = _coco_164k_files(self.root, split)

    def _load_raw(self, idx):
        return self._load_164k(self.files[idx])


class Coco164kFew(_CocoFewMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.init_label_space(config)
        self.files = _coco_164k_files(self.root, split)

    def _load_raw(self, idx):
        return self._load_164k(self.files[idx])


class Coco164kCuratedFew(_CocoFewMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.init_label_space(config)
        self.files = _coco_curated_files(self.root, split,
                                         _curated_few_name(config))

    def _load_raw(self, idx):
        return self._load_164k(self.files[idx])


class Coco164kCuratedFull(_CocoFullMixin, _CocoBase):
    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        if not config.use_coarse_labels:
            raise ValueError("Coco164kCuratedFull needs --use_coarse_labels")
        self.init_label_space(config)
        name = f"Coco164kFull_Stuff_Coarse_{config.coco_164k_curated_version}"
        self.files = _coco_curated_files(self.root, split, name)

    def _load_raw(self, idx):
        return self._load_164k(self.files[idx])


# ------------------------------------------------------------------ Potsdam

class Potsdam(_SegDatasetBase):
    """Potsdam aerial tiles: imgs/<id>.mat ("img", uint8 rgb + ir, 200 x
    200), gt/<id>.mat ("gt") for labelled tiles only; the splits are
    <split>.txt lists; 6 fine classes, coarse = roads + cars / buildings +
    clutter / vegetation + trees."""

    FINE_TO_COARSE = np.array([0, 1, 2, 2, 0, 1], np.int32)

    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        self.root = config.dataset_root
        self.use_coarse_labels = config.use_coarse_labels
        _expect_gt_k(config, 3 if self.use_coarse_labels else 6)
        if split not in ("unlabelled_train", "labelled_train",
                         "labelled_test"):
            raise ValueError(f"Potsdam split {split!r}")
        with open(osp.join(self.root, split + ".txt")) as f:
            self.files = [line.rstrip() for line in f]

    def _load_raw(self, idx):
        import scipy.io as sio
        image_id = self.files[idx]
        image = sio.loadmat(
            osp.join(self.root, "imgs", image_id + ".mat"))["img"]
        if image.dtype != np.uint8:
            raise ValueError(f"Potsdam tile {image_id}: {image.dtype}, "
                             "expected uint8")
        gt_path = osp.join(self.root, "gt", image_id + ".mat")
        label = None
        if osp.exists(gt_path):
            label = sio.loadmat(gt_path)["gt"].astype(np.int32)
        return image, label

    def _filter_label(self, label):
        if self.use_coarse_labels:
            label = self.FINE_TO_COARSE[label]
        mask = np.ones(label.shape, bool)
        return label, mask


# ---------------------------------------------------------------- synthetic


def _parse_name(config, prefix):
    """(k, sz, n) from <prefix><K>x<SZ>[x<N>] (n defaults to 256)."""
    fields = [int(v) for v in config.dataset[len(prefix):].split("x")]
    return fields[0], fields[1], (fields[2] if len(fields) > 2 else 256)


class SyntheticSeg(_SegDatasetBase):
    """Clusterable synthetic segmentation data: label map = smooth spatial
    class field; image = class-dependent texture + noise. Name:
    SyntheticSeg<K>x<SZ>[x<N>] (C_raw = 3) or SyntheticSegPotsdam<K>x<SZ>
    [x<N>] (C_raw = 4, rgb + ir)."""

    def __init__(self, config, split, purpose):
        super().__init__(config, split, purpose)
        c_raw = 3
        prefix = "SyntheticSeg"
        if config.dataset.startswith("SyntheticSegPotsdam"):
            prefix, c_raw = "SyntheticSegPotsdam", 4
        k, sz, n = _parse_name(config, prefix)
        if split in ("test", "val", "labelled_test"):
            n = max(n // 4, 8)
        if k != self.gt_k:
            raise ValueError(f"{config.dataset}: {k} classes, gt_k "
                             f"{self.gt_k}")
        rng = np.random.default_rng(0 if "train" in str(split) else 1)
        yy, xx = np.mgrid[0:sz, 0:sz].astype(np.float32) / sz
        self.images = np.zeros((n, sz, sz, c_raw), np.uint8)
        self.labels = np.zeros((n, sz, sz), np.int32)
        for i in range(n):
            cx = rng.uniform(0.2, 0.8, k)
            cy = rng.uniform(0.2, 0.8, k)
            scales = rng.uniform(0.5, 2.0, k)
            fields_ = np.stack([
                -scales[c] * ((xx - cx[c]) ** 2 + (yy - cy[c]) ** 2)
                for c in range(k)])
            lab = np.argmax(fields_, axis=0)
            chans = [
                0.5 + 0.45 * np.sin(2 * np.pi * (lab + 1) * (c + 1) / k
                                    + xx * 3)
                for c in range(3)]
            if c_raw == 4:  # ir: a distinct label-dependent band
                chans.append(
                    0.5 + 0.45 * np.cos(2 * np.pi * (lab + 1) / k + yy * 3))
            img = np.stack(chans, axis=-1)
            img += 0.1 * rng.standard_normal(img.shape)
            self.images[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self.labels[i] = lab
        self.files = list(range(n))

    def _load_raw(self, idx):
        return self.images[idx], self.labels[idx]

    def _filter_label(self, label):
        return label, np.ones(label.shape, bool)

    def label_filter_table(self):
        return np.arange(-1, self.gt_k, dtype=np.int32)


class SyntheticSegStripes(SyntheticSeg):
    """Texture-only synthetic segmentation: every class is a sinusoidal
    grating of the same mean and amplitude, told apart only by orientation
    (horizontal / vertical, so a horizontal flip keeps the class) and
    frequency, with a random phase per image. Telling classes apart needs
    spatial context. Name: SyntheticSegStripes<K>x<SZ>[x<N>]."""

    def __init__(self, config, split, purpose):
        _SegDatasetBase.__init__(self, config, split, purpose)
        k, sz, n = _parse_name(config, "SyntheticSegStripes")
        if split in ("test", "val", "labelled_test"):
            n = max(n // 4, 8)
        if k != self.gt_k:
            raise ValueError(f"{config.dataset}: {k} classes, gt_k "
                             f"{self.gt_k}")
        rng = np.random.default_rng(0 if "train" in str(split) else 1)
        yy, xx = np.mgrid[0:sz, 0:sz].astype(np.float32)
        base_period = 8.0  # px; well inside net10a's 30-px receptive field
        self.images = np.zeros((n, sz, sz, 3), np.uint8)
        self.labels = np.zeros((n, sz, sz), np.int32)
        for i in range(n):
            cx = rng.uniform(0.2, 0.8, k)
            cy = rng.uniform(0.2, 0.8, k)
            scales = rng.uniform(0.5, 2.0, k)
            fields_ = np.stack([
                -scales[c] * ((xx / sz - cx[c]) ** 2
                              + (yy / sz - cy[c]) ** 2)
                for c in range(k)])
            lab = np.argmax(fields_, axis=0)
            tex = np.zeros((sz, sz), np.float32)
            for c in range(k):
                coord = xx if c % 2 == 0 else yy
                freq = 2.0 * np.pi / base_period * (2 ** (c // 2))
                phase = rng.uniform(0, 2 * np.pi)
                tex = np.where(lab == c,
                               0.5 + 0.45 * np.sin(freq * coord + phase),
                               tex)
            img = np.repeat(tex[:, :, None], 3, axis=-1)
            img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
            self.images[i] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            self.labels[i] = lab
        self.files = list(range(n))


SEG_DATASETS = {
    "Coco10kFull": Coco10kFull,
    "Coco10kFew": Coco10kFew,
    "Coco164kFull": Coco164kFull,
    "Coco164kFew": Coco164kFew,
    "Coco164kCuratedFew": Coco164kCuratedFew,
    "Coco164kCuratedFull": Coco164kCuratedFull,
    "Potsdam": Potsdam,
}


def build_seg_dataset(config, split, purpose):
    if config.dataset.startswith("SyntheticSegStripes"):
        return SyntheticSegStripes(config, split, purpose)
    if config.dataset.startswith("SyntheticSeg"):
        return SyntheticSeg(config, split, purpose)
    if config.dataset not in SEG_DATASETS:
        raise ValueError(f"unknown segmentation dataset {config.dataset!r}")
    return SEG_DATASETS[config.dataset](config, split, purpose)
