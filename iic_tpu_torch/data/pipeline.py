"""Clustering input pipelines (``iic_tpu/data/pipeline.py``).

The reference zips ``1 + num_dataloaders`` epoch-aligned loaders over one
sequential order: each training batch is one tf1 sub-batch repeated
``num_dataloaders`` times, paired with independent tf2 draws. Here the raw
uint8 batch goes to the device through ``prefetch.DeviceUpload`` (on a
CUDA device: from pinned memory on a copy stream of its own), and one
batched ``augment_pair`` applies tf1 once per image and tf2
``num_dataloaders`` times: the same pairing, no host-side augmentation.
Each batch's draws come from a ``torch.Generator`` seeded from (seed,
epoch, batch), so a run is reproducible.

Ported: the two-head scripts' pipelines (sobel and greyscale) and the
single-head IID+ scripts', over the readers (MNIST, CIFAR, STL10 with
``--mix_train``, Digits, DigitsNuisance, Synthetic), eager or, under
``--lazy_images``, decoded on access; their sharding over ranks
(``process_shard``); and ``create_basic_clustering_dataloaders``, which
clusters a user's own image folder in a seeded shuffled order. Resident
mode is not ported.

With a lazy reader a batch's rows are read from disk (or decoded) inside
``ClusterTrainPipeline.epoch``'s generator. The trainers run that
generator on the host prefetch thread (``host_prefetch_iter``), so batch
i + 1 is read while batch i trains; ``MappingLoader`` reads each eval
batch as it yields it.
"""

import os

import numpy as np
import torch

from iic_tpu_torch.data import readers
from iic_tpu_torch.data.prefetch import DeviceUpload
from iic_tpu_torch.data.seg_pipeline import batch_generator
from iic_tpu_torch.data.transforms import (
    make_greyscale_pair_transforms, make_sobel_pair_transforms)
from iic_tpu_torch.device import resolve_device


def _is_greyscale(config):
    if getattr(config, "greyscale", False):
        return True
    if config.dataset in ("MNIST",) or config.dataset.startswith("Digits"):
        return True
    if config.dataset.startswith("Synthetic"):
        # Synthetic<K>x<SZ>x<C>[x<N>]: channels is the third field
        return config.dataset[len("Synthetic"):].split("x")[2] == "1"
    return False


def _pair_transforms(config):
    if _is_greyscale(config):
        return make_greyscale_pair_transforms(config)
    return make_sobel_pair_transforms(config)


def _load_partitions(config, partitions):
    """(images uint8 (N, H, W, C), labels int32 (N,)) over the partitions,
    concatenated in order. STL10's train+unlabeled under ``--mix_train``
    is reordered so that each labelled image is followed by its share of
    the unlabelled ones (``readers.reorder_train_deterministic_ids``).
    Under ``--lazy_images`` the images stay on disk through both: the
    reorder is a ``.select`` and lazy parts are joined by a lazy array."""
    lazy = getattr(config, "lazy_images", False)
    parts = []
    for p in partitions:
        d = readers.load_dataset(config.dataset, config.dataset_root, p,
                                 lazy=lazy)
        imgs, labels = d["images"], d["labels"]
        if (config.dataset == "STL10" and p == "train+unlabeled"
                and config.mix_train):
            # the labelled count from the labels (the unlabelled are -1):
            # 5000 on the real STL10, and any size on a fixture tree
            n_train = int((labels >= 0).sum())
            ids = readers.reorder_train_deterministic_ids(
                n_train=n_train, per=(len(imgs) - n_train) // n_train)
            # fancy indexing would read the whole 105 000-image mix
            imgs = imgs.select(ids) if hasattr(imgs, "select") else imgs[ids]
            labels = labels[ids]
        parts.append((imgs, labels))
    if len(parts) == 1:
        return parts[0]
    labels = np.concatenate([p[1] for p in parts])
    if lazy and all(hasattr(p[0], "select") for p in parts):
        # each lazy part reads its own rows; the join adds no layout
        return readers.LazyBinaryArray(
            [p[0] for p in parts], lambda x: x, parts[0][0].shape[1:]), labels
    return np.concatenate([np.asarray(p[0]) for p in parts]), labels


class ClusterTrainPipeline:
    """Yields (base uint8 (b, H, W, C) on ``device``, generator) batches in
    the sequential order of the partitions, and exposes ``augment_pair``
    (and ``augment_tf1``, its tf1 half) for the train step. The ragged last
    batch is kept, or dropped under ``drop_last``.

    ``deterministic_shuffle`` visits each epoch in a seeded order instead,
    ``np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    .permutation(n)``, the JAX pipeline's (so restart-reproducible).

    ``process_shard = (rank, world)`` with world > 1 (the JAX package's
    multi-host rule): each rank yields ((its contiguous sub-block of the
    batch, the block's weights (float32)), generator), the generator its
    own. A ragged final batch is padded to the full batch with its last
    image, weighted 0. A rank reads only its own rows, from a lazy array
    too."""

    def __init__(self, config, partitions, seed=0, device="cpu",
                 preloaded=None, drop_last=False, process_shard=None,
                 deterministic_shuffle=False):
        self.config = config
        self.seed = seed
        self.deterministic_shuffle = deterministic_shuffle
        self.device = torch.device(device)
        self.process_shard = process_shard or (0, 1)
        self.num_dataloaders = config.num_dataloaders
        self.dataloader_batch_sz = config.batch_sz // config.num_dataloaders
        self.images, self.labels = (preloaded if preloaded is not None
                                    else _load_partitions(config, partitions))
        rounder = np.floor if drop_last else np.ceil
        self.num_batches = max(int(rounder(
            len(self.images) / self.dataloader_batch_sz)), 1)
        tf1, tf2, _ = _pair_transforms(config)
        r = self.num_dataloaders
        self.upload = DeviceUpload(self.device)

        def augment_pair(imgs_u8, generator):
            """(b, H, W, C) uint8 -> the (b*r, C', sz, sz) float32 pair,
            NCHW. tf1 is drawn once per image and tiled r times block-wise
            (image i sits at rows i, b+i, 2b+i, ...); tf2 is drawn
            independently for each of the b*r rows."""
            imgs = imgs_u8.float() / 255.0
            base = tf1(imgs, generator)
            tiled = imgs.repeat(r, 1, 1, 1)
            return (base.repeat(r, 1, 1, 1).permute(0, 3, 1, 2).contiguous(),
                    tf2(tiled, generator).permute(0, 3, 1, 2).contiguous())

        def augment_tf1(imgs_u8, generator):
            """(b, H, W, C) uint8 -> tf1 of each image tiled r times
            block-wise, (b*r, C', sz, sz) float32 NCHW: ``augment_pair``'s
            first output alone (the triplets baseline's negatives)."""
            base = tf1(imgs_u8.float() / 255.0, generator)
            return base.repeat(r, 1, 1, 1).permute(0, 3, 1, 2).contiguous()

        self.augment_pair = augment_pair
        self.augment_tf1 = augment_tf1

    def epoch_order(self, epoch_idx):
        """The epoch's visiting order under ``deterministic_shuffle``, else
        None (sequential)."""
        if not self.deterministic_shuffle:
            return None
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed, epoch_idx])).permutation(len(self.images))

    def shard_indices(self, b_i, order=None):
        """(this rank's image indices of batch ``b_i``, their weights):
        the batch's indices (in ``order`` when given) padded to the full
        batch with its last index (weight 0), then the rank's contiguous
        sub-block."""
        bsz = self.dataloader_batch_sz
        pi, pc = self.process_shard
        if bsz % pc:
            raise ValueError(f"a batch of {bsz} does not split over {pc} "
                             "ranks")
        lo, n = b_i * bsz, len(self.images)
        m = min(lo + bsz, n) - lo  # the valid rows
        idx = np.minimum(np.arange(lo, lo + bsz), lo + m - 1)
        if order is not None:
            idx = order[idx]
        weights = (np.arange(bsz) < m).astype(np.float32)
        shard = bsz // pc
        sl = slice(pi * shard, (pi + 1) * shard)
        return idx[sl], weights[sl]

    def epoch(self, epoch_idx, augmented=False):
        """The epoch's batches: (base_u8, generator), or the augmented pair
        (imgs, imgs_tf) when ``augmented``; sharded: ((base_u8, weights),
        generator). A lazy array's rows are read here, on the thread that
        iterates the generator."""
        bsz = self.dataloader_batch_sz
        pi, pc = self.process_shard
        if pc > 1 and augmented:
            raise ValueError("a sharded pipeline yields base batches")
        order = self.epoch_order(epoch_idx)
        for b_i in range(self.num_batches):
            if pc > 1:
                idx, weights = self.shard_indices(b_i, order)
                base, w = self.upload(
                    np.ascontiguousarray(self.images[idx]), weights)
                yield ((base, w), batch_generator(
                    self.seed, epoch_idx, b_i, self.device, pi))
                continue
            rows = (slice(b_i * bsz, (b_i + 1) * bsz) if order is None
                    else order[b_i * bsz:(b_i + 1) * bsz])
            base, = self.upload(np.ascontiguousarray(self.images[rows]))
            gen = batch_generator(self.seed, epoch_idx, b_i, self.device)
            yield self.augment_pair(base, gen) if augmented else (base, gen)

    def __len__(self):
        return self.num_batches


class MappingLoader:
    """tf3 (deterministic) eval loader: yields (imgs NCHW float32 on
    ``device``, labels int32 numpy) in batches of ``batch_sz``.
    ``truncate_pc`` keeps a random fixed fraction of the set, the rows of
    ``np.random.default_rng(truncate_seed).permutation`` the JAX loader
    keeps (the fewer-labels analysis)."""

    def __init__(self, config, partitions, device="cpu", preloaded=None,
                 truncate_pc=None, truncate_seed=0):
        self.config = config
        self.device = torch.device(device)
        self.batch_sz = config.batch_sz
        self.images, self.labels = (preloaded if preloaded is not None
                                    else _load_partitions(config, partitions))
        if truncate_pc is not None:
            n = int(len(self.images) * truncate_pc)
            idx = np.random.default_rng(truncate_seed).permutation(
                len(self.images))[:n]
            # a lazy array stays lazy: re-indexed, not read
            self.images = (self.images.select(idx)
                           if hasattr(self.images, "select")
                           else self.images[idx])
            self.labels = self.labels[idx]
        _, _, self.tf3 = _pair_transforms(config)

    def __iter__(self):
        for start in range(0, len(self.images), self.batch_sz):
            imgs = torch.from_numpy(np.ascontiguousarray(
                self.images[start:start + self.batch_sz])).to(self.device)
            out = self.tf3(imgs.float() / 255.0)
            yield (out.permute(0, 3, 1, 2).contiguous(),
                   self.labels[start:start + self.batch_sz])

    def __len__(self):
        return int(np.ceil(len(self.images) / self.batch_sz))


def _twohead_partitions(config):
    """(train A, train B, mapping assignment, mapping test) partitions, the
    reference's table: train and test together for CIFAR, MNIST, Digits
    and Synthetic; for STL10 head A also trains on the unlabelled images
    (unless ``--stl_leave_out_unlabelled``), which needs ``--mix_train``."""
    ds = config.dataset
    if ("CIFAR" in ds or ds == "MNIST" or ds.startswith("Digits")
            or ds.startswith("Synthetic")):
        both = [True, False]
        return both, both, both, both
    if ds == "STL10":
        if not config.mix_train:
            raise ValueError("the two-head scripts on STL10 need "
                             "--mix_train")
        train_a = (["train", "test"] if config.stl_leave_out_unlabelled
                   else ["train+unlabeled", "test"])
        both = ["train", "test"]
        return train_a, both, both, both
    raise NotImplementedError(f"dataset {ds!r} has no partition table in "
                              "the clustering scripts (an image folder: "
                              "create_basic_clustering_dataloaders)")


def _shared(loaded, partitions):
    """The decoded (images, labels) of a pipeline or loader in ``loaded``,
    a list of (partitions, data), over the same partitions, or None."""
    return next((data for parts, data in loaded if parts == partitions),
                None)


def cluster_twohead_create_dataloaders(config, seed=0, device="cpu",
                                       drop_last=False, process_shard=None):
    """Returns (train pipeline head A, train pipeline head B, mapping
    assignment loader, mapping test loader). Head B's pipeline is seeded
    ``seed + 1``. Pipelines and loaders over the same partitions share the
    decoded images: all four do, but on STL10, where head A's mix of
    train+unlabeled has its own. ``drop_last`` and ``process_shard`` go to
    the train pipelines; every rank's mapping loaders hold the whole
    sets."""
    if config.mode != "IID":
        raise ValueError(f"the two-head scripts run mode IID, got "
                         f"{config.mode}")
    train_a, train_b, map_a, map_t = _twohead_partitions(config)
    config.train_partitions_head_A = train_a
    config.train_partitions_head_B = train_b
    config.mapping_assignment_partitions = map_a
    config.mapping_test_partitions = map_t
    shard = dict(drop_last=drop_last, process_shard=process_shard)
    pipe_a = ClusterTrainPipeline(config, train_a, seed=seed, device=device,
                                  **shard)
    loaded = [(train_a, (pipe_a.images, pipe_a.labels))]
    pipe_b = ClusterTrainPipeline(config, train_b, seed=seed + 1,
                                  device=device,
                                  preloaded=_shared(loaded, train_b),
                                  **shard)
    loaded.append((train_b, (pipe_b.images, pipe_b.labels)))
    map_assign = MappingLoader(config, map_a, device=device,
                               preloaded=_shared(loaded, map_a))
    map_test = MappingLoader(config, map_t, device=device,
                             preloaded=_shared(loaded, map_t))
    return pipe_a, pipe_b, map_assign, map_test


def create_basic_clustering_dataloaders(config, seed=0, device=None):
    """The one-function entry point for a user's own images (the
    reference's ``create_basic_clustering_dataloaders``): class-per-
    subfolder images under ``config.dataset_root/train`` (``--dataset
    ImageFolder``; ``--lazy_images`` decodes them on access), visited in a
    seeded shuffled order (``deterministic_shuffle``), the same images and
    order for both heads (head B shares head A's decoded arrays). The
    labelled mapping loaders are built over ``dataset_root/none`` only
    where that directory exists, else they are None. ``config.greyscale``
    picks the greyscale transforms. Any other dataset name falls back to
    ``cluster_twohead_create_dataloaders``. ``device`` defaults to cuda:0
    (an error with no GPU).

    Returns (train pipeline head A, train pipeline head B, mapping
    assignment loader, mapping test loader)."""
    device = resolve_device(device)
    if config.dataset != "ImageFolder":
        return cluster_twohead_create_dataloaders(config, seed=seed,
                                                  device=device)
    assert config.batchnorm_track  # as the reference recommends
    train = ["train"]
    config.train_partitions_head_A = train
    config.train_partitions_head_B = train
    pipe_a = ClusterTrainPipeline(config, train, seed=seed, device=device,
                                  deterministic_shuffle=True)
    pipe_b = ClusterTrainPipeline(config, train, seed=seed, device=device,
                                  deterministic_shuffle=True,
                                  preloaded=(pipe_a.images, pipe_a.labels))
    map_assign = map_test = None
    if os.path.isdir(os.path.join(config.dataset_root, "none")):
        config.mapping_assignment_partitions = ["none"]
        config.mapping_test_partitions = ["none"]
        map_assign = MappingLoader(config, ["none"], device=device)
        map_test = MappingLoader(config, ["none"], device=device,
                                 preloaded=(map_assign.images,
                                            map_assign.labels))
    return pipe_a, pipe_b, map_assign, map_test


def cluster_create_dataloaders(config, seed=0, device="cpu",
                               drop_last=False, process_shard=None):
    """The single-head IID+ scripts' (``iic_tpu/data/pipeline.py``:
    ``cluster_create_dataloaders``): the train split trains and maps, the
    test split is held out (STL10: train+unlabeled trains, train maps).
    Returns (train pipeline, mapping assignment loader, mapping test
    loader)."""
    if config.mode != "IID+":
        raise ValueError(f"the single-head scripts run mode IID+, got "
                         f"{config.mode}")
    ds = config.dataset
    if ("CIFAR" in ds or ds == "MNIST" or ds.startswith("Digits")
            or ds.startswith("Synthetic")):
        train, map_a, map_t = [True], [True], [False]
    elif ds == "STL10":
        train, map_a, map_t = ["train+unlabeled"], ["train"], ["test"]
    else:
        raise NotImplementedError(f"dataset {ds!r} has no partition table "
                                  "in the clustering scripts (an image "
                                  "folder: create_basic_clustering_"
                                  "dataloaders)")
    config.train_partitions = train
    config.mapping_assignment_partitions = map_a
    config.mapping_test_partitions = map_t
    pipe = ClusterTrainPipeline(config, train, seed=seed, device=device,
                                drop_last=drop_last,
                                process_shard=process_shard)
    loaded = [(train, (pipe.images, pipe.labels))]
    return (pipe,
            MappingLoader(config, map_a, device=device,
                          preloaded=_shared(loaded, map_a)),
            MappingLoader(config, map_t, device=device,
                          preloaded=_shared(loaded, map_t)))
