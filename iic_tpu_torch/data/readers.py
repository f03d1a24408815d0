"""Host-side dataset readers for clustering (``iic_tpu/data/readers.py``),
numpy only.

Every reader returns ``{"images": uint8 (N, H, W, C), "labels": int32
(N,)}``. Ported: the CIFAR-10/100/20 python pickles and the clusterable
synthetic generator (``Synthetic<K>x<SZ>x<C>[x<N>]``), which stands in where
the real files are absent. The other names (MNIST, STL10, ImageFolder, the
sklearn digits) raise ``NotImplementedError``.
"""

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
    "CIFAR10": load_cifar10,
    "CIFAR100": load_cifar100,
    "CIFAR20": load_cifar20,
}


def load_dataset(name, root, partition):
    """``partition`` is True (train) or False (test). ``Synthetic<K>x<SZ>x
    <C>[x<N>]`` generates N training images (default 2048) and a test split
    of max(N // 4, 4K)."""
    if name.startswith("Synthetic"):
        fields = [int(v) for v in name[len("Synthetic"):].split("x")]
        k, sz, c = fields[:3]
        n_train = fields[3] if len(fields) > 3 else 2048
        is_train = partition in (True, "train", "train+unlabeled")
        n = n_train if is_train else max(n_train // 4, k * 4)
        return make_synthetic(n, k, sz, c, seed=0 if is_train else 1)
    if name not in _LOADERS:
        raise NotImplementedError(f"dataset {name!r} is not ported; ported: "
                                  f"{sorted(_LOADERS)} and Synthetic*")
    return _LOADERS[name](root, train=partition)
