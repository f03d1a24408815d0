"""Segmentation input pipeline (``iic_tpu/data/seg_pipeline.py``).

The host does the variable-shape geometry (crop, label mask; see
``seg_datasets``) and ships uint8 batches to the device through
``prefetch.DeviceUpload`` (on a CUDA device: from pinned memory on a copy
stream of its own). One batched device function then does the rest: colour
jitter of img2, grey / sobel channel prep, optional random RSS affine of
img2 (recording affine2_to_1), and the random horizontal flip of img2 that
negates the affine's top row, giving the training 4-tuple
(img1, img2, affine2_to_1, mask).

Ported: the numpy host path. Resident mode, the native C++ host prep and
multi-process sharding are not ported (the trainer refuses their flags).
"""

import numpy as np
import torch

from iic_tpu_torch.data.prefetch import DeviceUpload
from iic_tpu_torch.data.seg_datasets import build_seg_dataset
from iic_tpu_torch.data.seg_transforms import seg_random_affine
from iic_tpu_torch.data.transforms import (
    append_grey, color_jitter_with, draw_jitter, to_grey)


def _channel_prep(rgb, sobel, include_rgb):
    """(B, H, W, 3) -> the sobel-ready / grey / rgb channels, HWC."""
    if sobel:
        return append_grey(rgb, include_rgb)
    return rgb if include_rgb else to_grey(rgb)


def make_seg_augment(config):
    """Returns ``augment(imgs_u8, masks_u8, generator)``, which composes its
    two attributes:

      augment.draw(b, generator, device) -> dict of per-sample draws;
      augment.apply(imgs_u8 (b, sz, sz, C_raw) uint8, masks_u8 (b, sz, sz),
        draws) -> (img1, img2, affine2_to_1 (b, 2, 3), mask float32), the
        images NCHW.

    Tests feed ``apply`` fixed draws. C_raw is 3 (rgb) or 4 (rgb + ir)."""
    using_ir = config.using_IR
    sobel = config.sobel
    include_rgb = config.include_rgb
    flip_p = config.flip_p
    use_random_affine = getattr(config, "use_random_affine", False)
    aff = dict(
        min_rot=getattr(config, "aff_min_rot", -30.0),
        max_rot=getattr(config, "aff_max_rot", 30.0),
        min_shear=getattr(config, "aff_min_shear", -10.0),
        max_shear=getattr(config, "aff_max_shear", 10.0),
        min_scale=getattr(config, "aff_min_scale", 0.8),
        max_scale=getattr(config, "aff_max_scale", 1.2))
    jitter = dict(brightness=config.jitter_brightness,
                  contrast=config.jitter_contrast,
                  saturation=config.jitter_saturation,
                  hue=config.jitter_hue)

    def draw(b, generator, device):
        factors, order = draw_jitter(b, generator, device, **jitter)
        affine_u = torch.rand((b, 3), generator=generator, device=device)
        flip_u = torch.rand((b,), generator=generator, device=device)
        return dict(jitter_factors=factors, jitter_order=order,
                    affine_u=affine_u, flip_u=flip_u)

    def apply(imgs_u8, masks_u8, draws):
        img = imgs_u8.float() / 255.0
        rgb, ir = (img[..., :3], img[..., 3:4]) if using_ir else (img, None)
        img1 = rgb
        img2 = color_jitter_with(rgb, draws["jitter_factors"],
                                 draws["jitter_order"])
        img1 = _channel_prep(img1, sobel, include_rgb)
        img2 = _channel_prep(img2, sobel, include_rgb)
        if ir is not None:
            img1 = torch.cat([img1, ir], dim=-1)
            img2 = torch.cat([img2, ir], dim=-1)
        img1 = img1.permute(0, 3, 1, 2).contiguous()
        img2 = img2.permute(0, 3, 1, 2).contiguous()
        b = img1.shape[0]
        if use_random_affine:
            img2, aff2to1 = seg_random_affine(img2, draws["affine_u"], **aff)
        else:
            aff2to1 = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]],
                                   device=img1.device).expand(b, 2, 3)
        # the reference flips when rand() > flip_p
        do_flip = draws["flip_u"] > flip_p
        img2 = torch.where(do_flip[:, None, None, None], img2.flip(3), img2)
        sign = torch.tensor([[-1.0], [1.0]], device=img1.device)
        aff2to1 = torch.where(do_flip[:, None, None], aff2to1 * sign,
                              aff2to1)
        return img1, img2, aff2to1.contiguous(), masks_u8.float()

    def augment(imgs_u8, masks_u8, generator):
        draws = draw(imgs_u8.shape[0], generator, imgs_u8.device)
        return apply(imgs_u8, masks_u8, draws)

    augment.draw = draw
    augment.apply = apply
    return augment


def batch_generator(seed, epoch_idx, b_i, device):
    """The augmentation generator of batch ``b_i`` of one epoch."""
    state = np.random.SeedSequence([seed + 7919, epoch_idx, b_i])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> 1))


class SegTrainPipeline:
    """Yields (imgs_u8, masks_u8, generator) batches on ``device`` and
    exposes ``augment`` for the train step. Shuffles each epoch when
    num_dataloaders == 1, keeps sequential order otherwise.

    num_dataloaders = r > 1: each training batch is the same
    ``dataloader_batch_sz`` base images repeated r times, each repeat with
    its own geometry / augmentation draw, ``batch_sz`` pairs in all."""

    def __init__(self, config, partitions, seed=0, device="cpu",
                 drop_last=False):
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        self.datasets = [build_seg_dataset(config, p, "train")
                         for p in partitions]
        self.lengths = [len(d) for d in self.datasets]
        self.total = sum(self.lengths)
        self.batch_sz = config.dataloader_batch_sz
        rounder = np.floor if drop_last else np.ceil
        self.num_batches = max(int(rounder(self.total / self.batch_sz)), 1)
        self.shuffle = config.num_dataloaders == 1
        self.augment = make_seg_augment(config)
        self.upload = DeviceUpload(self.device)

    def _locate(self, global_idx):
        for d, n in zip(self.datasets, self.lengths):
            if global_idx < n:
                return d, global_idx
            global_idx -= n
        raise IndexError(global_idx)

    def _numpy_batch(self, idxs, rng):
        """Host prep of one batch. With no rescale, uniform raw shapes of at
        least input_sz and a table-form label filter, a batched path draws
        the crop centres in the exact order ``pad_and_or_crop`` does (same
        rng stream, same batches) and crops with memcpys; otherwise each
        sample goes through ``get_train``."""
        cfg = self.config
        sz = cfg.input_sz
        located = [self._locate(int(i)) for i in idxs]
        use_fast = (not getattr(cfg, "pre_scale_all", False)
                    and not getattr(cfg, "use_random_scale", False))
        if use_fast:
            raws = [d._load_raw(i) for d, i in located]
            h, w = raws[0][0].shape[:2]
            have_labels = all(r[1] is not None for r in raws)
            table = located[0][0].label_filter_table()
            tables_ok = (not have_labels) or (
                table is not None and all(
                    np.array_equal(d.label_filter_table(), table)
                    for d, _ in located[1:]))
            use_fast = (len({r[0].shape for r in raws}) == 1
                        and h >= sz and w >= sz and tables_ok)
        if not use_fast:
            samples = [d.get_train(i, rng) for d, i in located]
            return (np.stack([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]))

        b = len(idxs)
        half = sz // 2
        if sz % 2 == 1:
            h_c_max, w_c_max = h - 1 - half, w - 1 - half
        else:
            h_c_max, w_c_max = h - half, w - half
        starts = np.empty((b, 2), np.int64)
        for j in range(b):  # the same two draws per sample
            starts[j, 0] = int(rng.integers(half, h_c_max + 1)) - half
            starts[j, 1] = int(rng.integers(half, w_c_max + 1)) - half
        c = raws[0][0].shape[2] if raws[0][0].ndim == 3 else 1
        imgs = np.empty((b, sz, sz, c), np.uint8)
        masks = np.ones((b, sz, sz), np.uint8)
        keep = (table >= 0).astype(np.uint8) if have_labels else None
        for j, (img, lab) in enumerate(raws):
            y, x = starts[j]
            imgs[j] = img[y:y + sz, x:x + sz].reshape(sz, sz, c)
            if keep is not None:
                masks[j] = keep[lab[y:y + sz, x:x + sz] + 1]
        return imgs, masks

    def _epoch_order(self, epoch_idx):
        """(visiting order, rng continuing from the permutation draw)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx]))
        order = (rng.permutation(self.total) if self.shuffle
                 else np.arange(self.total))
        return order, rng

    def epoch(self, epoch_idx):
        order, rng = self._epoch_order(epoch_idx)
        r = self.config.num_dataloaders
        for b_i in range(self.num_batches):
            idxs = order[b_i * self.batch_sz:(b_i + 1) * self.batch_sz]
            if r > 1:  # r independent draws of the same base images
                idxs = np.concatenate([idxs] * r)
            imgs, masks = self.upload(*self._numpy_batch(idxs, rng))
            yield (imgs, masks,
                   batch_generator(self.seed, epoch_idx, b_i, self.device))

    def __len__(self):
        return self.num_batches


class SegMappingLoader:
    """Eval loader: yields (imgs NCHW float32 on the device, sobel-ready
    channels; labels int32 (b, sz, sz) numpy; masks (b, sz, sz) numpy)."""

    def __init__(self, config, partitions, device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.batch_sz = config.eval_batch_sz or config.batch_sz
        self.datasets = [build_seg_dataset(config, p, "test")
                         for p in partitions]
        self.lengths = [len(d) for d in self.datasets]
        self.total = sum(self.lengths)

    def transform(self, imgs_u8):
        img = imgs_u8.float() / 255.0
        cfg = self.config
        rgb, ir = (img[..., :3], img[..., 3:4]) if cfg.using_IR else (img,
                                                                      None)
        out = _channel_prep(rgb, cfg.sobel, cfg.include_rgb)
        if ir is not None:
            out = torch.cat([out, ir], dim=-1)
        return out.permute(0, 3, 1, 2).contiguous()

    def _get(self, global_idx):
        for d, n in zip(self.datasets, self.lengths):
            if global_idx < n:
                return d.get_test(global_idx)
            global_idx -= n
        raise IndexError(global_idx)

    def __iter__(self):
        for start in range(0, self.total, self.batch_sz):
            samples = [self._get(i) for i in
                       range(start, min(start + self.batch_sz, self.total))]
            imgs = torch.from_numpy(np.stack([s[0] for s in samples]))
            yield (self.transform(imgs.to(self.device)),
                   np.stack([s[1] for s in samples]),
                   np.stack([s[2] for s in samples]))

    def __len__(self):
        return int(np.ceil(self.total / self.batch_sz))


def segmentation_create_dataloaders(config, seed=0, device="cpu",
                                    drop_last=False):
    """Partition tables + loaders. Returns (train_pipeline,
    mapping_assignment_loader, mapping_test_loader)."""
    if getattr(config, "mask_input", False):
        raise ValueError("mask_input is unsupported (the reference asserts "
                         "it off too)")
    train, map_a, map_t = seg_partitions(config)
    config.train_partitions = train
    config.mapping_assignment_partitions = map_a
    config.mapping_test_partitions = map_t
    return (SegTrainPipeline(config, train, seed=seed, device=device,
                             drop_last=drop_last),
            SegMappingLoader(config, map_a, device=device),
            SegMappingLoader(config, map_t, device=device))


def seg_partitions(config):
    """Per-mode (train, mapping_assignment, mapping_test) partition lists,
    derivable from (mode, dataset) alone."""
    ds = config.dataset
    if config.mode == "IID+":
        if "Coco10k" in ds:
            return ["train"], ["train"], ["test"]
        if "Coco164k" in ds:
            return ["train2017"], ["train2017"], ["val2017"]
        if ds == "Potsdam":
            return (["unlabelled_train", "labelled_train"],
                    ["labelled_train"], ["labelled_test"])
        if ds.startswith("SyntheticSeg"):
            return ["train"], ["train"], ["test"]
        raise NotImplementedError(ds)
    if config.mode == "IID":
        if "Coco10k" in ds:
            return ["all"], ["all"], ["all"]
        if "Coco164k" in ds:
            both = ["train2017", "val2017"]
            return both, both, both
        if ds == "Potsdam":
            return (["unlabelled_train", "labelled_train", "labelled_test"],
                    ["labelled_train", "labelled_test"],
                    ["labelled_train", "labelled_test"])
        if ds.startswith("SyntheticSeg"):
            return ["train"], ["train"], ["train"]
        raise NotImplementedError(ds)
    raise ValueError(config.mode)
