"""Host-side dataset readers for clustering (``iic_tpu/data/readers.py``),
numpy only at import.

Every reader returns ``{"images": uint8 (N, H, W, C), "labels": int32
(N,)}``, label -1 for an unlabelled sample: MNIST idx files (raw or
``.gz``), the CIFAR-10/100/20 python pickles, the STL10 binaries, a user's
class-per-subfolder images (``ImageFolder``), the UCI optical digits
(``Digits``, from the port's own copy, ``digits.npz``) and their nuisance
variant (``DigitsNuisance``), and the clusterable synthetic generator
(``Synthetic<K>x<SZ>x<C>[x<N>]``), which stands in where the real files
are absent.

``lazy=True`` (``--lazy_images``) keeps the images on disk: MNIST's raw idx
rasters and the STL10 binaries are memory-mapped (``LazyBinaryArray``), an
image folder's files are decoded on access (``LazyImageArray``). Either
reads only the rows a batch asks for, so STL10's 2.6 GB unlabelled split
streams through the loaders instead of sitting in host memory. ``.gz``
MNIST files, CIFAR and the Digits sets decode eagerly whatever ``lazy``
says. OpenCV and PIL (ImageFolder, DigitsNuisance) are imported inside the
functions that use them.
"""

import gzip
import os
import pickle

import numpy as np

# CIFAR-100 fine -> coarse (CIFAR20), CIFAR-100's own coarse-label hierarchy
CIFAR100_TO_CIFAR20 = np.array([
    4, 1, 14, 8, 0, 6, 7, 7, 18, 3, 3, 14, 9, 18, 7, 11, 3, 9, 7, 11,
    6, 11, 5, 10, 7, 6, 13, 15, 3, 15, 0, 11, 1, 10, 12, 14, 16, 9, 11, 5,
    5, 19, 8, 8, 15, 13, 14, 17, 18, 10, 16, 4, 17, 4, 2, 0, 17, 4, 18, 17,
    10, 3, 2, 12, 12, 16, 12, 1, 9, 19, 2, 10, 0, 1, 16, 12, 9, 13, 15, 13,
    16, 19, 2, 4, 6, 19, 5, 5, 8, 19, 18, 1, 2, 15, 6, 0, 17, 8, 14, 13,
], dtype=np.int32)


def _find(root, *candidates):
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


def _read_idx(path):
    """An idx file (raw or ``.gz``) as a uint8 array of its dimensions."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = int.from_bytes(data[0:4], "big") & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


def _as_index_list(idx):
    """An index array, list or bool mask as a flat array of indices."""
    arr = np.asarray(idx)
    if arr.dtype == bool:  # a boolean mask, not 0/1 integer indices
        arr = np.flatnonzero(arr)
    return arr.reshape(-1)


class LazyBinaryArray:
    """A decode-on-demand view over memory-mapped rasters (MNIST idx,
    STL10 ``*_X.bin``): ``np.memmap`` parts, one after another, and a
    layout ``transform`` applied to each gathered batch, so pages are read
    from disk per accessed batch and the whole set never needs to sit in
    host memory. It stands in for the eager uint8 array wherever the
    pipelines index one: ``len``, ``.shape``, ``.dtype``; int, slice, fancy
    and bool-mask ``__getitem__`` (decoded uint8 numpy); ``.select`` (a
    still-lazy re-index); ``np.asarray`` (the whole set)."""

    dtype = np.dtype(np.uint8)

    def __init__(self, parts, transform, item_shape, idx=None):
        self.parts = list(parts)
        lens = [len(p) for p in self.parts]
        self._starts = np.cumsum([0] + lens)
        self.idx = (np.arange(self._starts[-1], dtype=np.int64)
                    if idx is None else np.asarray(idx, np.int64))
        self.transform = transform
        self.item_shape = tuple(int(s) for s in item_shape)

    @property
    def shape(self):
        return (len(self.idx),) + self.item_shape

    def __len__(self):
        return len(self.idx)

    def _materialise(self, gidx):
        """The rows ``gidx`` (indices into the parts laid end to end),
        transformed, as one contiguous uint8 array."""
        raw_shape = self.parts[0].shape[1:]
        if len(gidx) == 0:
            return np.zeros((0,) + self.item_shape, np.uint8)
        part_of = np.searchsorted(self._starts, gidx, side="right") - 1
        raw = np.empty((len(gidx),) + raw_shape, np.uint8)
        # one vectorised gather a part, not one an item: a batch from one
        # part, or the whole train+unlabeled mix, is a few numpy calls
        for pi in np.unique(part_of):
            sel = part_of == pi
            raw[sel] = self.parts[pi][gidx[sel] - self._starts[pi]]
        return np.ascontiguousarray(self.transform(raw))

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._materialise(self.idx[idx:][:1])[0]
        if isinstance(idx, slice):
            return self._materialise(self.idx[idx])
        return self._materialise(self.idx[_as_index_list(idx)])

    def select(self, idx):
        """A lazy re-index (truncation, reorder): no page is read."""
        return LazyBinaryArray(self.parts, self.transform, self.item_shape,
                               idx=self.idx[_as_index_list(idx)])

    def __array__(self, dtype=None, copy=None):
        out = self._materialise(self.idx)
        return out.astype(dtype) if dtype is not None else out


def _memmap_idx(path):
    """An ``np.memmap`` over an uncompressed idx file's raster."""
    with open(path, "rb") as f:
        ndim = int.from_bytes(f.read(4), "big") & 0xFF
        dims = [int.from_bytes(f.read(4), "big") for _ in range(ndim)]
    return np.memmap(path, dtype=np.uint8, mode="r",
                     offset=4 + 4 * ndim, shape=tuple(dims))


def load_mnist(root, train=True, lazy=False):
    """MNIST idx files, raw or ``.gz``, under root, root/raw or
    root/MNIST/raw -> images (N, 28, 28, 1). ``lazy`` memory-maps a raw
    image file (``LazyBinaryArray``); a ``.gz`` one decodes eagerly."""
    prefix = "train" if train else "t10k"
    for sub in ("", "raw", "MNIST/raw"):
        base = os.path.join(root, sub)
        imgs_p = _find(base, f"{prefix}-images-idx3-ubyte",
                       f"{prefix}-images-idx3-ubyte.gz")
        lbls_p = _find(base, f"{prefix}-labels-idx1-ubyte",
                       f"{prefix}-labels-idx1-ubyte.gz")
        if imgs_p and lbls_p:
            labels = _read_idx(lbls_p).astype(np.int32)
            if lazy and not imgs_p.endswith(".gz"):
                mm = _memmap_idx(imgs_p)
                images = LazyBinaryArray(
                    [mm], lambda x: x[..., None], mm.shape[1:] + (1,))
            else:
                images = _read_idx(imgs_p)[..., None]
            return {"images": images, "labels": labels}
    raise FileNotFoundError(f"MNIST idx files not found under {root}")


def _load_cifar_batch(path):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    imgs = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs, d


def load_cifar10(root, train=True):
    base = _find(root, "cifar-10-batches-py", "")
    if base is None or not os.path.isdir(base):
        raise FileNotFoundError(f"CIFAR-10 not found under {root}")
    if train:
        imgs_list, lbls = [], []
        for i in range(1, 6):
            imgs, d = _load_cifar_batch(os.path.join(base, f"data_batch_{i}"))
            imgs_list.append(imgs)
            lbls += d["labels"]
        return {"images": np.concatenate(imgs_list),
                "labels": np.array(lbls, np.int32)}
    imgs, d = _load_cifar_batch(os.path.join(base, "test_batch"))
    return {"images": imgs, "labels": np.array(d["labels"], np.int32)}


def load_cifar100(root, train=True, coarse=False):
    base = _find(root, "cifar-100-python", "")
    if base is None or not os.path.isdir(base):
        raise FileNotFoundError(f"CIFAR-100 not found under {root}")
    imgs, d = _load_cifar_batch(os.path.join(base,
                                             "train" if train else "test"))
    fine = np.array(d["fine_labels"], np.int32)
    return {"images": imgs,
            "labels": CIFAR100_TO_CIFAR20[fine] if coarse else fine}


def load_cifar20(root, train=True):
    """CIFAR-100 with its fine labels mapped to the 20 coarse classes."""
    return load_cifar100(root, train=train, coarse=True)


def _read_stl_bin(path):
    """An STL10 ``*_X.bin``: column-major 96 x 96 x 3 an image -> (N, 96,
    96, 3)."""
    arr = np.fromfile(path, dtype=np.uint8)
    n = arr.size // (3 * 96 * 96)
    return arr.reshape(n, 3, 96, 96).transpose(0, 3, 2, 1)


def _memmap_stl_bin(path):
    n = os.path.getsize(path) // (3 * 96 * 96)
    return np.memmap(path, dtype=np.uint8, mode="r", shape=(n, 3, 96, 96))


_STL_TO_NHWC = (0, 3, 2, 1)  # column-major 96 x 96 x 3, the STL10 format

_STL_SPLITS = {"train": ["train"], "test": ["test"],
               "unlabeled": ["unlabeled"],
               "train+unlabeled": ["train", "unlabeled"]}


def load_stl10(root, split="train", lazy=False):
    """The STL10 binary splits under root/stl10_binary (or root): train,
    test, unlabeled and train+unlabeled. Labels are the file's minus 1, and
    -1 for a part with no ``*_y.bin`` (the unlabelled images). ``lazy``
    memory-maps the ``*_X.bin`` files (``LazyBinaryArray``;
    train+unlabeled is a lazy two-part array)."""
    base = _find(root, "stl10_binary", "")
    if base is None or not os.path.isdir(base):
        raise FileNotFoundError(f"STL10 not found under {root}")
    if split not in _STL_SPLITS:
        raise ValueError(split)
    parts = _STL_SPLITS[split]
    read = _memmap_stl_bin if lazy else _read_stl_bin
    imgs = [read(os.path.join(base, f"{part}_X.bin")) for part in parts]
    labels = []
    for part, im in zip(parts, imgs):
        lbl_path = os.path.join(base, f"{part}_y.bin")
        labels.append(
            np.fromfile(lbl_path, dtype=np.uint8).astype(np.int32) - 1
            if os.path.exists(lbl_path) else np.full(len(im), -1, np.int32))
    if lazy:
        images = LazyBinaryArray(
            imgs, lambda x: x.transpose(_STL_TO_NHWC), (96, 96, 3))
    else:
        images = imgs[0] if len(imgs) == 1 else np.concatenate(imgs)
    return {"images": images, "labels": np.concatenate(labels)}


_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


class LazyImageArray:
    """A decode-on-demand view of an image folder's stack: it holds the
    files' paths and decodes on access, so a folder larger than host
    memory streams through the loaders batch by batch. It stands in for
    the eager (n, h, w, 3) uint8 array as ``LazyBinaryArray`` does: every
    decode resizes to ``target_hw`` exactly as ``load_image_folder``
    does."""

    dtype = np.dtype(np.uint8)

    def __init__(self, paths, target_hw):
        self.paths = list(paths)
        self.target_hw = (int(target_hw[0]), int(target_hw[1]))

    @property
    def shape(self):
        return (len(self.paths),) + self.target_hw + (3,)

    def __len__(self):
        return len(self.paths)

    def _decode(self, path):
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            # kept by the scan (PIL opens it) but not decodable by cv2:
            # PIL's decode, with the EXIF orientation cv2 would apply
            img = _pil_decode_rgb(path)
            if img is None:
                raise IOError(f"undecodable image: {path}")
        if img.shape[:2] != self.target_hw:
            img = cv2.resize(img, (self.target_hw[1], self.target_hw[0]),
                             interpolation=cv2.INTER_LINEAR)
        return img

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._decode(self.paths[idx])
        if isinstance(idx, slice):
            paths = self.paths[idx]
        else:
            paths = [self.paths[int(i)] for i in _as_index_list(idx)]
        if not paths:
            return np.zeros((0,) + self.target_hw + (3,), np.uint8)
        return np.stack([self._decode(p) for p in paths])

    def select(self, idx):
        """A lazy re-index (truncation, reorder): nothing is decoded."""
        return LazyImageArray(
            [self.paths[int(i)] for i in _as_index_list(idx)],
            self.target_hw)

    def __array__(self, dtype=None, copy=None):
        out = self[np.arange(len(self.paths))]
        return out.astype(dtype) if dtype is not None else out


def _scan_image_folder(root, subdir):
    """(sorted class names, the files' paths, int32 labels): one class a
    subfolder of root/subdir, classes and the files of each sorted, files
    kept by their extension (``_IMG_EXTS``, any case)."""
    base = os.path.join(root, subdir) if subdir else root
    if not os.path.isdir(base):
        raise FileNotFoundError(base)
    classes = sorted(d for d in os.listdir(base)
                     if os.path.isdir(os.path.join(base, d)))
    if not classes:
        raise FileNotFoundError(f"no class subfolders under {base}")
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(base, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    if not paths:
        raise FileNotFoundError(f"no images under {base}")
    return classes, paths, np.array(labels, np.int32)


def _pil_decode_rgb(path):
    """PIL's decode as RGB uint8 (h, w, 3), with the EXIF orientation
    applied as cv2.imread applies it; None where PIL cannot decode it
    either."""
    try:
        from PIL import Image, ImageOps

        with Image.open(path) as im:
            im = ImageOps.exif_transpose(im)
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


# EXIF orientations 5-8 turn the raster by 90 or 270 degrees: the decoded
# (h, w) is the header's transposed
_EXIF_ORIENTATION_TAG = 0x0112
_EXIF_TRANSPOSED = (5, 6, 7, 8)


def load_image_folder_lazy(root, subdir):
    """``load_image_folder``'s files, labels and shape, decoded on access
    (``LazyImageArray``). Each file's (h, w) comes from its header alone
    (PIL's ``Image.open`` reads no pixels), turned by its EXIF orientation
    as cv2.imread turns the raster; the modal (h, w) is picked as the eager
    reader picks it. A file PIL cannot open is dropped here; one PIL opens
    but cv2 cannot decode is decoded by PIL on access."""
    from PIL import Image

    _, paths, labels = _scan_image_folder(root, subdir)
    shapes, keep = [], []
    for i, p in enumerate(paths):
        try:
            with Image.open(p) as im:
                w, h = im.size
                try:
                    orientation = im.getexif().get(_EXIF_ORIENTATION_TAG)
                except Exception:
                    orientation = None
                if orientation in _EXIF_TRANSPOSED:
                    h, w = w, h
        except Exception:
            continue
        shapes.append((h, w))
        keep.append(i)
    if not keep:
        raise FileNotFoundError(f"no decodable images under "
                                f"{os.path.join(root, subdir or '')}")
    modal = max(set(shapes), key=shapes.count)
    return {"images": LazyImageArray([paths[i] for i in keep], modal),
            "labels": labels[keep]}


def load_image_folder(root, subdir):
    """torchvision's ImageFolder layout, decoded up front: one class a
    subfolder of root/subdir, classes sorted by name and files sorted in
    each. cv2 decodes (BGR -> RGB, EXIF orientation applied); a file cv2
    cannot decode is decoded by PIL, and dropped where PIL cannot either.
    Images of another (h, w) than the most common one are resized to it
    (``cv2.INTER_LINEAR``), so the set stacks."""
    import cv2

    _, paths, all_labels = _scan_image_folder(root, subdir)
    imgs, labels = [], []
    for p, lab in zip(paths, all_labels):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is not None:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        else:
            img = _pil_decode_rgb(p)
            if img is None:
                continue
        imgs.append(img)
        labels.append(lab)
    if not imgs:
        raise FileNotFoundError(f"no decodable images under "
                                f"{os.path.join(root, subdir or '')}")
    shapes = [im.shape[:2] for im in imgs]
    if len(set(shapes)) > 1:
        # the mode of whole (h, w) pairs: modes taken axis by axis could
        # make a shape no image has
        modal = max(set(shapes), key=shapes.count)
        imgs = [im if im.shape[:2] == modal else
                cv2.resize(im, (modal[1], modal[0]),
                           interpolation=cv2.INTER_LINEAR)
                for im in imgs]
    return {"images": np.stack(imgs), "labels": np.array(labels, np.int32)}


DIGITS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.npz")


def load_digits(train=True, upscale=3):
    """The UCI optical digits as scikit-learn ships them
    (``sklearn.datasets.load_digits``: 1797 images of 8 x 8, values 0-16,
    10 classes), read from the port's copy ``digits.npz``. Scaled to uint8
    by round(v * 255 / 16), nearest-upsampled x ``upscale`` (8 -> 24), so
    MNIST's crop and rotation flags apply unchanged; the first 1500 images
    are the train split, the last 297 the test split."""
    with np.load(DIGITS_NPZ) as d:
        images, target = d["images"].astype(np.float64), d["target"]
    imgs = np.round(images * (255.0 / 16.0)).astype(np.uint8)
    imgs = np.repeat(np.repeat(imgs, upscale, axis=1), upscale, axis=2)
    imgs = imgs[..., None]  # (N, 8u, 8u, 1)
    labels = target.astype(np.int32)
    sl = slice(0, 1500) if train else slice(1500, None)
    return {"images": imgs[sl], "labels": labels[sl]}


def load_digits_nuisance(train=True, canvas=32, upscale=3, seed=0):
    """The digits (``load_digits``, 24 x 24) with a fixed nuisance drawn
    once an image: rotated by U(-30, 30) degrees about the centre
    (``cv2.warpAffine``, bilinear), contrast scaled by U(0.5, 1) and placed
    at a uniform offset in a ``canvas`` x ``canvas`` frame. The draws come
    from ``np.random.default_rng(seed)`` (train) or ``seed + 1`` (test), so
    the set is deterministic: the nuisance the MNIST tf2 marginalises over,
    a probe of whether a trunk's features are invariant to it."""
    import cv2

    base = load_digits(train=train, upscale=upscale)
    imgs, labels = base["images"], base["labels"]
    rng = np.random.default_rng(seed if train else seed + 1)
    d = imgs.shape[1]
    assert canvas >= d, (canvas, d)
    m = canvas - d
    out = np.zeros((len(imgs), canvas, canvas, 1), np.uint8)
    for i, im in enumerate(imgs):
        ang = float(rng.uniform(-30.0, 30.0))
        contrast = float(rng.uniform(0.5, 1.0))
        y, x = (int(v) for v in rng.integers(0, m + 1, 2))
        mat = cv2.getRotationMatrix2D((d / 2.0, d / 2.0), ang, 1.0)
        rot = cv2.warpAffine(im[:, :, 0].astype(np.float32), mat, (d, d))
        out[i, y:y + d, x:x + d, 0] = np.clip(
            rot * contrast, 0, 255).astype(np.uint8)
    return {"images": out, "labels": labels}


def reorder_train_deterministic_ids(n_train=5000, per=20):
    """STL10's ``--mix_train`` order: each of the first ``n_train`` ids
    followed by ``per`` ids of the unlabelled part after it (the real
    split: 5000 labelled, 20 of the 100000 unlabelled after each)."""
    ids = []
    for i in range(n_train):
        ids.append(i)
        ids.extend(range(n_train + i * per, n_train + (i + 1) * per))
    return np.array(ids, dtype=np.int64)


def make_synthetic(n, num_classes, sz, channels, seed=0, noise=0.35):
    """Clusterable synthetic images: each class a distinct smooth spatial
    pattern plus noise. Bit-identical to the JAX package's generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:sz, 0:sz].astype(np.float32) / sz
    patterns = []
    for c in range(num_classes):
        fx = 1 + (c % 4)
        fy = 1 + (c // 4)
        phase = c * 0.7
        base = 0.5 + 0.5 * np.sin(2 * np.pi * fx * xx + phase) * \
            np.cos(2 * np.pi * fy * yy + 0.3 * phase)
        patterns.append(base)
    patterns = np.stack(patterns)  # (K, sz, sz)

    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = patterns[labels][..., None]  # (N, sz, sz, 1)
    imgs = np.repeat(imgs, channels, axis=-1)
    imgs = imgs + noise * rng.standard_normal(imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0, 1)
    return {"images": (imgs * 255).astype(np.uint8), "labels": labels}


# the readers that decode eagerly whatever ``lazy`` says: CIFAR is pickled
# (nothing to memory-map) and the Digits sets are small
_EAGER_LOADERS = {
    "CIFAR10": load_cifar10,
    "CIFAR100": load_cifar100,
    "CIFAR20": load_cifar20,
    "Digits": lambda root, train: load_digits(train),
    "DigitsNuisance": lambda root, train: load_digits_nuisance(train),
}


def load_dataset(name, root, partition, lazy=False):
    """``partition`` is True (train) or False (test), or an STL10 split
    name, or an image folder's subfolder (True and False: train and test).
    ``Synthetic<K>x<SZ>x<C>[x<N>]`` generates N training images (default
    2048) and a test split of max(N // 4, 4K). ``lazy`` returns MNIST's,
    STL10's and ImageFolder's images decoded on access (see
    ``LazyBinaryArray``, ``LazyImageArray``)."""
    if name.startswith("Synthetic"):
        fields = [int(v) for v in name[len("Synthetic"):].split("x")]
        k, sz, c = fields[:3]
        n_train = fields[3] if len(fields) > 3 else 2048
        is_train = partition in (True, "train", "train+unlabeled")
        n = n_train if is_train else max(n_train // 4, k * 4)
        return make_synthetic(n, k, sz, c, seed=0 if is_train else 1)
    if name == "ImageFolder":
        sub = partition if isinstance(partition, str) else (
            "train" if partition else "test")
        return (load_image_folder_lazy(root, sub) if lazy
                else load_image_folder(root, sub))
    if name == "MNIST":
        return load_mnist(root, train=partition, lazy=lazy)
    if name == "STL10":
        return load_stl10(root, split=partition, lazy=lazy)
    if name not in _EAGER_LOADERS:
        known = sorted(["ImageFolder", "MNIST", "STL10", *_EAGER_LOADERS])
        raise ValueError(f"unknown dataset {name!r}: expected one of {known} "
                         "or Synthetic*")
    return _EAGER_LOADERS[name](root, partition)
