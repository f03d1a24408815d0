"""The semi-supervised finetune's data (``iic_tpu/data/semisup.py``).

``ten_crop``: torchvision's TenCrop, batched on the device: each image
expands into 10 crops (the four corners and the centre, then the same
five of the horizontally flipped image). ``make_tencrop_batch_fn`` ends
them in the grey append and keeps each image's 10 crops contiguous, the
blocks the block-averaged eval reads. ``SemisupTrainLoader`` yields the
shuffled supervised batches; their augmentation (tf2) runs in the train
step.
"""

import numpy as np
import torch

from iic_tpu_torch.data.prefetch import DeviceUpload
from iic_tpu_torch.data.seg_pipeline import batch_generator
from iic_tpu_torch.data.transforms import append_grey

# the label of a padded row of a sharded batch: F.cross_entropy's
# ignore_index, so the row weighs nothing
PAD_LABEL = -100


def ten_crop(imgs, crop_sz):
    """(B, H, W, C) -> (B, 10, crop_sz, crop_sz, C) in TenCrop's order: top
    left, top right, bottom left, bottom right, centre, then the same five
    of the flipped image. The centre's offset is the floor of half the
    difference, as in TenCrop."""
    h, w = imgs.shape[1:3]
    s = crop_sz
    top, left = (h - s) // 2, (w - s) // 2

    def five(im):
        return [im[:, :s, :s], im[:, :s, w - s:], im[:, h - s:, :s],
                im[:, h - s:, w - s:], im[:, top:top + s, left:left + s]]

    return torch.stack(five(imgs) + five(imgs.flip(2)), dim=1)


def make_tencrop_batch_fn(input_sz, include_rgb, grey_append=True):
    """(B, H, W, C) uint8 -> (B * 10, C', input_sz, input_sz) float32 NCHW,
    image i's crops in rows 10 i to 10 i + 9; C' after the grey append
    (rgb + grey or grey), or C without it (the greyscale path)."""

    def fn(imgs_u8):
        # times the f32 reciprocal: XLA's division by a constant, so the
        # crops equal the JAX function's bit for bit
        crops = ten_crop(imgs_u8.float() * (1.0 / 255.0), input_sz)
        crops = crops.reshape(-1, *crops.shape[2:])
        if grey_append:
            crops = append_grey(crops, include_rgb)
        return crops.permute(0, 3, 1, 2).contiguous()

    return fn


class SemisupTrainLoader:
    """Shuffled supervised train loader: yields (images uint8 (b, H, W, C)
    and labels int64 (b,) on ``device``, generator). Each epoch's order is
    the JAX loader's (numpy ``default_rng(SeedSequence([seed, epoch]))``'s
    permutation), so the batches hold the same images; each batch's
    augmentation draws from its own generator, seeded from (seed, epoch,
    batch). The ragged last batch is kept.

    ``process_shard = (rank, world)`` with world > 1: each rank yields its
    contiguous sub-block of each batch, with a generator of its own; a
    ragged final batch is padded to the full batch with its last image,
    labelled ``PAD_LABEL``."""

    def __init__(self, images, labels, batch_sz, seed=0, device="cpu",
                 process_shard=None):
        self.images = images
        self.labels = np.asarray(labels, np.int64)
        self.batch_sz = batch_sz
        self.seed = seed
        self.device = torch.device(device)
        self.process_shard = process_shard or (0, 1)
        self.num_batches = int(np.ceil(len(images) / batch_sz))
        self.upload = DeviceUpload(self.device)

    def order(self, epoch_idx):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx]))
        return rng.permutation(len(self.images))

    def epoch(self, epoch_idx):
        order = self.order(epoch_idx)
        pi, pc = self.process_shard
        for b_i in range(self.num_batches):
            idx = order[b_i * self.batch_sz:(b_i + 1) * self.batch_sz]
            labels = self.labels[idx]
            if pc > 1:
                if self.batch_sz % pc:
                    raise ValueError(f"a batch of {self.batch_sz} does not "
                                     f"split over {pc} ranks")
                m = len(idx)
                idx = np.concatenate(
                    [idx, np.full(self.batch_sz - m, idx[-1])])
                labels = np.concatenate(
                    [labels, np.full(self.batch_sz - m, PAD_LABEL)])
                shard = self.batch_sz // pc
                sl = slice(pi * shard, (pi + 1) * shard)
                idx, labels = idx[sl], labels[sl]
            imgs, labels = self.upload(
                np.ascontiguousarray(self.images[idx]), labels)
            yield (imgs, labels,
                   batch_generator(self.seed, epoch_idx, b_i, self.device,
                                   pi if pc > 1 else None))

    def __len__(self):
        return self.num_batches
