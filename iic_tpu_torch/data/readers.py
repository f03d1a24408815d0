"""Host-side dataset readers for clustering (``iic_tpu/data/readers.py``),
numpy only.

Every reader returns ``{"images": uint8 (N, H, W, C), "labels": int32
(N,)}``, label -1 for an unlabelled sample. Ported: MNIST idx files (raw or
``.gz``), the CIFAR-10/100/20 python pickles, the STL10 binaries, the UCI
optical digits (``Digits``, from the port's own copy, ``digits.npz``) and
the clusterable synthetic generator (``Synthetic<K>x<SZ>x<C>[x<N>]``), which
stands in where the real files are absent. All decode eagerly (the JAX
package's memory-mapped readers, ``--lazy_images``, are not ported);
``ImageFolder`` and ``DigitsNuisance`` (which needs OpenCV) raise
``NotImplementedError``.
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


def load_mnist(root, train=True):
    """MNIST idx files, raw or ``.gz``, under root, root/raw or
    root/MNIST/raw -> images (N, 28, 28, 1)."""
    prefix = "train" if train else "t10k"
    for sub in ("", "raw", "MNIST/raw"):
        base = os.path.join(root, sub)
        imgs_p = _find(base, f"{prefix}-images-idx3-ubyte",
                       f"{prefix}-images-idx3-ubyte.gz")
        lbls_p = _find(base, f"{prefix}-labels-idx1-ubyte",
                       f"{prefix}-labels-idx1-ubyte.gz")
        if imgs_p and lbls_p:
            return {"images": _read_idx(imgs_p)[..., None],
                    "labels": _read_idx(lbls_p).astype(np.int32)}
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


_STL_SPLITS = {"train": ["train"], "test": ["test"],
               "unlabeled": ["unlabeled"],
               "train+unlabeled": ["train", "unlabeled"]}


def load_stl10(root, split="train"):
    """The STL10 binary splits under root/stl10_binary (or root): train,
    test, unlabeled and train+unlabeled. Labels are the file's minus 1, and
    -1 for a part with no ``*_y.bin`` (the unlabelled images)."""
    base = _find(root, "stl10_binary", "")
    if base is None or not os.path.isdir(base):
        raise FileNotFoundError(f"STL10 not found under {root}")
    if split not in _STL_SPLITS:
        raise ValueError(split)
    imgs, labels = [], []
    for part in _STL_SPLITS[split]:
        im = _read_stl_bin(os.path.join(base, f"{part}_X.bin"))
        lbl_path = os.path.join(base, f"{part}_y.bin")
        labels.append(
            np.fromfile(lbl_path, dtype=np.uint8).astype(np.int32) - 1
            if os.path.exists(lbl_path) else np.full(len(im), -1, np.int32))
        imgs.append(im)
    return {"images": imgs[0] if len(imgs) == 1 else np.concatenate(imgs),
            "labels": np.concatenate(labels)}


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


_LOADERS = {
    "MNIST": load_mnist,
    "CIFAR10": load_cifar10,
    "CIFAR100": load_cifar100,
    "CIFAR20": load_cifar20,
    "STL10": load_stl10,
    "Digits": lambda root, train: load_digits(train),
}


def load_dataset(name, root, partition):
    """``partition`` is True (train) or False (test), or an STL10 split
    name. ``Synthetic<K>x<SZ>x<C>[x<N>]`` generates N training images
    (default 2048) and a test split of max(N // 4, 4K)."""
    if name.startswith("Synthetic"):
        fields = [int(v) for v in name[len("Synthetic"):].split("x")]
        k, sz, c = fields[:3]
        n_train = fields[3] if len(fields) > 3 else 2048
        is_train = partition in (True, "train", "train+unlabeled")
        n = n_train if is_train else max(n_train // 4, k * 4)
        return make_synthetic(n, k, sz, c, seed=0 if is_train else 1)
    if name == "DigitsNuisance":
        raise NotImplementedError("dataset 'DigitsNuisance' is not ported: "
                                  "its nuisance is drawn with OpenCV")
    if name not in _LOADERS:
        raise NotImplementedError(f"dataset {name!r} is not ported; ported: "
                                  f"{sorted(_LOADERS)} and Synthetic*")
    return _LOADERS[name](root, partition)
