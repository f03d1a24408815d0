"""Segmentation dataset readers, host side (``iic_tpu/data/seg_datasets.py``).

The host does what needs per-image shapes: pre-scale, random scale,
pad-and-crop to input_sz, label filtering and masking. Everything after the
crop runs batched on the device (``data/seg_pipeline.py``).

Outputs per sample:
  train: (img uint8 (sz, sz, C_raw), mask uint8 (sz, sz))
  test:  (img uint8 (sz, sz, C_raw), label int32 (sz, sz), mask uint8)

Ported so far: the synthetic sets. The COCO-Stuff and Potsdam readers raise
``NotImplementedError``.
"""

import numpy as np

from iic_tpu_torch.data.seg_transforms import pad_and_or_crop


def _resize_pair(img, label, fx):
    import cv2  # only rescaling configurations need OpenCV
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

    def get_train(self, idx, rng):
        img, label = self._load_raw(idx)
        img = img.astype(np.float32)
        if self.pre_scale_all:
            img, label = _resize_pair(img, label, self.pre_scale_factor)
        if self.use_random_scale:
            fx = rng.random() * (self.scale_max - self.scale_min) \
                + self.scale_min
            img, label = _resize_pair(img, label, fx)
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
        img, label = self._load_raw(idx)
        img = img.astype(np.float32)
        if self.pre_scale_all:
            img, label = _resize_pair(img, label, self.pre_scale_factor)
        img, _ = pad_and_or_crop(img, self.input_sz, mode="centre")
        label, _ = pad_and_or_crop(label, self.input_sz, mode="centre")
        label, mask = self._filter_label(label)
        return (img.astype(np.uint8), label.astype(np.int32),
                mask.astype(np.uint8))


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


def build_seg_dataset(config, split, purpose):
    if config.dataset.startswith("SyntheticSegStripes"):
        return SyntheticSegStripes(config, split, purpose)
    if config.dataset.startswith("SyntheticSeg"):
        return SyntheticSeg(config, split, purpose)
    raise NotImplementedError(
        f"dataset {config.dataset!r}: the COCO-Stuff and Potsdam readers are "
        "not ported yet; use SyntheticSeg* or SyntheticSegStripes*")
