"""Segmentation input pipeline (``iic_tpu/data/seg_pipeline.py``).

The host does the variable-shape geometry (crop, label mask; see
``seg_datasets``) and ships uint8 batches to the device through
``prefetch.DeviceUpload`` (on a CUDA device: from pinned memory on a copy
stream of its own). One batched device function then does the rest: colour
jitter of img2, grey / sobel channel prep, optional random RSS affine of
img2 (recording affine2_to_1), and the random horizontal flip of img2 that
negates the affine's top row, giving the training 4-tuple
(img1, img2, affine2_to_1, mask).

Two host paths prepare a batch from the same random draws: the native C++
prep (``iic_tpu_torch/native``, threaded over the batch) and numpy (a
batched fast path, else ``get_train`` per sample). Resident mode is not
ported (the trainer refuses its flag).
"""

import ctypes
import os

import numpy as np
import torch

from iic_tpu_torch import native
from iic_tpu_torch.data.prefetch import DeviceUpload, ThreadedPrefetch
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


def batch_generator(seed, epoch_idx, b_i, device, rank=None):
    """The augmentation generator of batch ``b_i`` of one epoch (of rank
    ``rank``'s shard, when the batch is sharded: each rank draws its own,
    as the JAX step folds the shard's index into its key)."""
    entropy = [seed + 7919, epoch_idx, b_i]
    if rank is not None:
        entropy += [97, rank]
    state = np.random.SeedSequence(entropy)
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> 1))


class SegTrainPipeline:
    """Yields (imgs_u8, masks_u8, generator) batches on ``device`` and
    exposes ``augment`` for the train step. Shuffles each epoch when
    num_dataloaders == 1, keeps sequential order otherwise.

    ``process_shard = (rank, world)`` with world > 1 (the JAX package's
    multi-host rule): the visiting order is global, and each rank preps
    only its contiguous sub-block of each batch (after the r repeats),
    with host draws and a generator of its own. A ragged final batch is
    padded to the full batch with its last image, whose relevancy masks
    are zeroed, so the loss leaves the padding out exactly; ``drop_last``
    drops it instead (parity mode).

    num_dataloaders = r > 1: each training batch is the same
    ``dataloader_batch_sz`` base images repeated r times, each repeat with
    its own geometry / augmentation draw, ``batch_sz`` pairs in all.

    ``use_native``: the native C++ host prep (True), numpy (False), or, by
    default, native on a host with at least 4 CPUs: its gain is threads
    over the samples, and on one core cv2's SIMD resize in the numpy path is
    the faster. The native library is built here when it is picked, and a
    failed build raises. ``use_fast_host=False`` sends every numpy batch
    through ``get_train`` (tests hold the batched path to it). The fast
    path keeps each image's raw-frame relevancy mask while their bytes stay
    within ``IIC_TPU_MASK_CACHE_BYTES`` (256 MiB by default)."""

    def __init__(self, config, partitions, seed=0, device="cpu",
                 drop_last=False, use_native=None, use_fast_host=True,
                 process_shard=None):
        self.config = config
        self.seed = seed
        self.process_shard = process_shard or (0, 1)
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
        self._fast_host = use_fast_host
        self._mask_cache = {}
        self._mask_cache_bytes = 0
        self._mask_cache_budget = int(os.environ.get(
            "IIC_TPU_MASK_CACHE_BYTES", 256 * 1024 * 1024))
        if use_native is None:
            use_native = (os.cpu_count() or 1) >= 4
        self._native = native.load_seg_prep() if use_native else None

    def _locate(self, global_idx):
        for d, n in zip(self.datasets, self.lengths):
            if global_idx < n:
                return d, global_idx
            global_idx -= n
        raise IndexError(global_idx)

    def _numpy_batch(self, idxs, rng):
        """Host prep of one batch on the numpy path. With no rescale,
        uniform raw shapes of at least input_sz and a table-form label
        filter, a batched path draws the crop centres in the exact order
        ``pad_and_or_crop`` does (same rng stream, same batches) and crops
        images and cached raw-frame masks with memcpys; otherwise each
        sample goes through ``get_train``."""
        cfg = self.config
        sz = cfg.input_sz
        located = [self._locate(int(i)) for i in idxs]
        use_fast = (self._fast_host
                    and not getattr(cfg, "pre_scale_all", False)
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
        for j, ((img, lab), (d, i)) in enumerate(zip(raws, located)):
            y, x = starts[j]
            imgs[j] = img[y:y + sz, x:x + sz].reshape(sz, sz, c)
            if keep is not None:
                # keep[lab + 1] is fixed per image, and the crop of the
                # cached frame equals the lookup of the cropped labels
                m_raw = self._mask_cache.get((id(d), int(i)))
                if m_raw is None:
                    m_raw = keep[lab + 1]
                    if (self._mask_cache_bytes + m_raw.nbytes
                            <= self._mask_cache_budget):
                        self._mask_cache[(id(d), int(i))] = m_raw
                        self._mask_cache_bytes += m_raw.nbytes
                masks[j] = m_raw[y:y + sz, x:x + sz]
        return imgs, masks

    def _draw_geometry(self, img_shape, rng):
        """``get_train``'s random draws for a raw image of ``img_shape``, in
        its order: (the pre-scale times the random scale, the crop centre in
        the scaled and padded frame)."""
        cfg = self.config
        scale = 1.0
        if getattr(cfg, "pre_scale_all", False):
            scale *= cfg.pre_scale_factor
        if getattr(cfg, "use_random_scale", False):
            scale *= (rng.random() * (cfg.scale_max - cfg.scale_min)
                      + cfg.scale_min)
        h, w = img_shape[:2]
        sh = max(int(round(h * scale)), 1) if scale != 1.0 else h
        sw = max(int(round(w * scale)), 1) if scale != 1.0 else w
        sz = cfg.input_sz
        ph, pw = max(sh, sz), max(sw, sz)
        h_c_min = w_c_min = int(sz / 2.0)
        if sz % 2 == 1:
            h_c_max, w_c_max = ph - 1 - sz // 2, pw - 1 - sz // 2
        else:
            h_c_max, w_c_max = ph - sz // 2, pw - sz // 2
        h_c = int(rng.integers(h_c_min, h_c_max + 1))
        w_c = int(rng.integers(w_c_min, w_c_max + 1))
        return scale, h_c, w_c

    def _native_batch(self, idxs, rng):
        """Host prep of one batch by the native library, from the random
        draws ``get_train`` makes. Without a rescale it equals the numpy
        path bit for bit; with one its bilinear resize differs from cv2's
        by a few grey levels."""
        sz = self.config.input_sz
        b = len(idxs)
        raws = []
        for gi in idxs:
            d, i = self._locate(int(gi))
            img, label = d._load_raw(i)
            if img.dtype != np.uint8 or img.ndim != 3:
                raise ValueError(f"native seg prep takes (h, w, c) uint8 "
                                 f"images, got {img.dtype} {img.shape}")
            table = d.label_filter_table()
            raws.append((np.ascontiguousarray(img),
                         None if table is None or label is None else
                         np.ascontiguousarray(label, dtype=np.int32),
                         table))
        channels = raws[0][0].shape[2]
        if any(r[0].shape[2] != channels for r in raws):
            raise ValueError("native seg prep: images of one batch differ in "
                             "channels")
        heights = np.array([r[0].shape[0] for r in raws], np.int32)
        widths = np.array([r[0].shape[1] for r in raws], np.int32)
        scales = np.empty(b, np.float32)
        h_cs = np.empty(b, np.int32)
        w_cs = np.empty(b, np.int32)
        for j, r in enumerate(raws):
            scales[j], h_cs[j], w_cs[j] = self._draw_geometry(r[0].shape, rng)

        table = raws[0][2]
        have_labels = table is not None and all(
            r[1] is not None for r in raws)
        if table is None:
            table = np.zeros(1, np.int32)
        table = np.ascontiguousarray(table, dtype=np.int32)
        img_ptrs = (ctypes.c_void_p * b)(*[r[0].ctypes.data for r in raws])
        lab_ptrs = ((ctypes.c_void_p * b)(*[r[1].ctypes.data for r in raws])
                    if have_labels else None)

        def ptr(a, ctype):
            return a.ctypes.data_as(ctypes.POINTER(ctype))

        imgs_out = np.empty((b, sz, sz, channels), np.uint8)
        masks_out = np.empty((b, sz, sz), np.uint8)
        ret = self._native.seg_prepare_batch(
            img_ptrs, lab_ptrs, ptr(heights, ctypes.c_int32),
            ptr(widths, ctypes.c_int32), channels, b,
            ptr(scales, ctypes.c_float), ptr(h_cs, ctypes.c_int32),
            ptr(w_cs, ctypes.c_int32), sz, ptr(table, ctypes.c_int32),
            len(table), ptr(imgs_out, ctypes.c_uint8),
            ptr(masks_out, ctypes.c_uint8), os.cpu_count() or 1)
        if ret != 0:
            raise RuntimeError(f"native seg_prepare_batch returned {ret}")
        return imgs_out, masks_out

    def _epoch_order(self, epoch_idx):
        """(visiting order, host rng): the rng continues from the
        permutation draw, or is the rank's own when the batch is
        sharded."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx]))
        order = (rng.permutation(self.total) if self.shuffle
                 else np.arange(self.total))
        pi, pc = self.process_shard
        if pc > 1:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch_idx, 97, pi]))
        return order, rng

    def shard_indices(self, idxs):
        """(this rank's dataset indices of one batch, the rows of them that
        are padding), from the batch's global indices ``idxs`` before the r
        repeats: the ragged batch padded with its last index, repeated r
        times, then the rank's contiguous sub-block. One process: the
        repeats alone and no padding."""
        r = self.config.num_dataloaders
        pi, pc = self.process_shard
        n_valid = len(idxs)
        if pc > 1 and n_valid < self.batch_sz:
            idxs = np.concatenate(
                [idxs, np.full(self.batch_sz - n_valid, idxs[-1])])
        idxs = np.concatenate([idxs] * r) if r > 1 else idxs
        padding = np.tile(np.arange(len(idxs) // r) >= n_valid, r)
        if pc > 1:
            if len(idxs) % pc:
                raise ValueError(f"a batch of {len(idxs)} does not split "
                                 f"over {pc} ranks")
            shard = len(idxs) // pc
            sl = slice(pi * shard, (pi + 1) * shard)
            idxs, padding = idxs[sl], padding[sl]
        return idxs, padding

    def epoch(self, epoch_idx):
        order, rng = self._epoch_order(epoch_idx)
        pi, pc = self.process_shard
        for b_i in range(self.num_batches):
            idxs, padding = self.shard_indices(
                order[b_i * self.batch_sz:(b_i + 1) * self.batch_sz])
            prep = (self._native_batch if self._native is not None
                    else self._numpy_batch)
            imgs, masks = prep(idxs, rng)
            if padding.any():
                masks[padding] = 0
            imgs, masks = self.upload(imgs, masks)
            yield (imgs, masks,
                   batch_generator(self.seed, epoch_idx, b_i, self.device,
                                   pi if pc > 1 else None))

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

    def _batches(self):
        for start in range(0, self.total, self.batch_sz):
            samples = [self._get(i) for i in
                       range(start, min(start + self.batch_sz, self.total))]
            imgs = torch.from_numpy(np.stack([s[0] for s in samples]))
            yield (self.transform(imgs.to(self.device)),
                   np.stack([s[1] for s in samples]),
                   np.stack([s[2] for s in samples]))

    def __iter__(self):
        # the next two batches' reads, crops and uploads overlap the
        # consumer's forward of this one
        return ThreadedPrefetch(self._batches(), depth=2)

    def __len__(self):
        return int(np.ceil(self.total / self.batch_sz))


def segmentation_create_dataloaders(config, seed=0, device="cpu",
                                    drop_last=False, process_shard=None):
    """Partition tables + loaders. Returns (train_pipeline,
    mapping_assignment_loader, mapping_test_loader). ``process_shard``
    goes to the train pipeline; every rank's mapping loaders hold the whole
    sets."""
    if getattr(config, "mask_input", False):
        raise ValueError("mask_input is unsupported (the reference asserts "
                         "it off too)")
    train, map_a, map_t = seg_partitions(config)
    config.train_partitions = train
    config.mapping_assignment_partitions = map_a
    config.mapping_test_partitions = map_t
    return (SegTrainPipeline(config, train, seed=seed, device=device,
                             drop_last=drop_last,
                             process_shard=process_shard),
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
