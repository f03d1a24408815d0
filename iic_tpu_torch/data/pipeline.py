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

Ported: the single-process, host-resident path of the two-head sobel
scripts. The greyscale transforms, STL10 / MNIST / ImageFolder, resident
mode and multi-process sharding are not (they raise).
"""

import numpy as np
import torch

from iic_tpu_torch.data import readers
from iic_tpu_torch.data.prefetch import DeviceUpload
from iic_tpu_torch.data.seg_pipeline import batch_generator
from iic_tpu_torch.data.transforms import make_sobel_pair_transforms


def _is_greyscale(config):
    if getattr(config, "greyscale", False):
        return True
    if config.dataset in ("MNIST",) or config.dataset.startswith("Digits"):
        return True
    if config.dataset.startswith("Synthetic"):
        # Synthetic<K>x<SZ>x<C>[x<N>]: channels is the third field
        return config.dataset[len("Synthetic"):].split("x")[2] == "1"
    return False


def _sobel_transforms(config):
    if _is_greyscale(config):
        raise NotImplementedError(
            f"{config.dataset}: the greyscale clustering transforms are not "
            "ported")
    return make_sobel_pair_transforms(config)


def _load_partitions(config, partitions):
    """(images uint8 (N, H, W, C), labels int32 (N,)) over the partitions,
    concatenated in order."""
    parts = [readers.load_dataset(config.dataset, config.dataset_root, p)
             for p in partitions]
    if len(parts) == 1:
        return parts[0]["images"], parts[0]["labels"]
    return (np.concatenate([p["images"] for p in parts]),
            np.concatenate([p["labels"] for p in parts]))


class ClusterTrainPipeline:
    """Yields (base uint8 (b, H, W, C) on ``device``, generator) batches in
    the sequential order of the partitions, and exposes ``augment_pair``
    for the train step. The ragged last batch is kept."""

    def __init__(self, config, partitions, seed=0, device="cpu",
                 preloaded=None):
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        self.num_dataloaders = config.num_dataloaders
        self.dataloader_batch_sz = config.batch_sz // config.num_dataloaders
        self.images, self.labels = (preloaded if preloaded is not None
                                    else _load_partitions(config, partitions))
        self.num_batches = max(int(np.ceil(
            len(self.images) / self.dataloader_batch_sz)), 1)
        tf1, tf2, _ = _sobel_transforms(config)
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

        self.augment_pair = augment_pair

    def epoch(self, epoch_idx, augmented=False):
        """The epoch's batches: (base_u8, generator), or the augmented pair
        (imgs, imgs_tf) when ``augmented``."""
        bsz = self.dataloader_batch_sz
        for b_i in range(self.num_batches):
            base, = self.upload(
                np.ascontiguousarray(self.images[b_i * bsz:(b_i + 1) * bsz]))
            gen = batch_generator(self.seed, epoch_idx, b_i, self.device)
            yield self.augment_pair(base, gen) if augmented else (base, gen)

    def __len__(self):
        return self.num_batches


class MappingLoader:
    """tf3 (deterministic) eval loader: yields (imgs NCHW float32 on
    ``device``, labels int32 numpy) in batches of ``batch_sz``."""

    def __init__(self, config, partitions, device="cpu", preloaded=None):
        self.config = config
        self.device = torch.device(device)
        self.batch_sz = config.batch_sz
        self.images, self.labels = (preloaded if preloaded is not None
                                    else _load_partitions(config, partitions))
        _, _, self.tf3 = _sobel_transforms(config)

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
    """(train A, train B, mapping assignment, mapping test) partitions: the
    train and test splits together everywhere (the reference's table for
    CIFAR)."""
    ds = config.dataset
    if "CIFAR" in ds or ds.startswith("Synthetic"):
        both = [True, False]
        return both, both, both, both
    raise NotImplementedError(f"dataset {ds!r} is not ported for the "
                              "two-head clustering scripts")


def cluster_twohead_create_dataloaders(config, seed=0, device="cpu"):
    """Returns (train pipeline head A, train pipeline head B, mapping
    assignment loader, mapping test loader). Head B's pipeline is seeded
    ``seed + 1``; all four share the decoded images."""
    if config.mode != "IID":
        raise ValueError(f"the two-head scripts run mode IID, got "
                         f"{config.mode}")
    train_a, train_b, map_a, map_t = _twohead_partitions(config)
    config.train_partitions_head_A = train_a
    config.train_partitions_head_B = train_b
    config.mapping_assignment_partitions = map_a
    config.mapping_test_partitions = map_t
    pipe_a = ClusterTrainPipeline(config, train_a, seed=seed, device=device)
    data = (pipe_a.images, pipe_a.labels)
    pipe_b = ClusterTrainPipeline(config, train_b, seed=seed + 1,
                                  device=device, preloaded=data)
    map_assign = MappingLoader(config, map_a, device=device, preloaded=data)
    map_test = MappingLoader(config, map_t, device=device, preloaded=data)
    return pipe_a, pipe_b, map_assign, map_test
