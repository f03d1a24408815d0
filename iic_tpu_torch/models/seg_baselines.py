"""Segmentation baseline networks (``iic_tpu/models/seg_baselines.py``):
Doersch context prediction and Isola adjacency prediction.

Both upsample the net10a trunk's features to the input size (bilinear,
half-pixel centres), take one patch a sample at each of two centres, run
each patch set through a siamese branch (3x3 conv -> 1024, BN, relu; the
same modules, called once a set, so each set is normalised with its own
batch statistics and moves the running statistics once) and the joint MLP
(Linear -> relu -> Dropout(0.5) -> Linear) to 9 position logits (Doersch)
or 1 adjacency logit (Isola). The branch's features are flattened in NCHW
order, so ``joint1``'s weight is the JAX ``joint_kernel1`` transposed. The
nets run in float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from iic_tpu_torch.models.layers import (
    Conv2d, batch_norm, kaiming_normal_fan_in_, linear_init_)
from iic_tpu_torch.models.segmentation_nets import SegmentationNet10aTrunk


def _slice_start(start, size, patch_side):
    """``jax.lax.dynamic_slice``'s start: a negative one counts from the
    end, then it is clamped so that the slice lies in the map."""
    start = torch.where(start < 0, start + size, start)
    return start.clamp(0, size - patch_side)


def get_patches(feats, centres, patch_side):
    """(N, C, H, W) features, (N, 2) integer (row, col) centres ->
    (N, C, patch_side, patch_side) at starts centre - patch_side // 2,
    placed as ``jax.lax.dynamic_slice`` places them (``_slice_start``):
    never raises, and a patch never crosses the map's edge. The trainers'
    centres all give starts in range."""
    n, _, h, w = feats.shape
    half = patch_side // 2
    centres = centres.to(device=feats.device, dtype=torch.long)
    offs = torch.arange(patch_side, device=feats.device)
    rows = _slice_start(centres[:, 0] - half, h, patch_side)[:, None] + offs
    cols = _slice_start(centres[:, 1] - half, w, patch_side)[:, None] + offs
    batch = torch.arange(n, device=feats.device)[:, None, None]
    patches = feats.permute(0, 2, 3, 1)[batch, rows[:, :, None],
                                        cols[:, None, :]]
    return patches.permute(0, 3, 1, 2)


class SiameseJointHead(nn.Module):
    """The JAX ``_SiameseJointHead``: ``siamese_conv`` / ``siamese_bn``
    (flax names), then ``joint1`` -> relu -> ``dropout`` -> ``joint2``."""

    def __init__(self, in_channels, patch_side, out_dim,
                 batchnorm_track=True):
        super().__init__()
        self.siamese_conv = Conv2d(in_channels, 1024, kernel_size=3,
                                   padding=1, bias=False)
        kaiming_normal_fan_in_(self.siamese_conv.weight)
        self.siamese_bn = batch_norm(1024, batchnorm_track)
        self.joint1 = linear_init_(nn.Linear(2 * 1024 * patch_side ** 2,
                                             1024))
        self.dropout = nn.Dropout(0.5)
        self.joint2 = linear_init_(nn.Linear(1024, out_dim))

    def _branch(self, patches):
        x = F.relu(self.siamese_bn(self.siamese_conv(patches)))
        return x.flatten(1)  # NCHW order

    def forward(self, patches1, patches2):
        concat = torch.cat([self._branch(patches1), self._branch(patches2)],
                           dim=1)
        x = self.dropout(F.relu(self.joint1(concat)))
        return self.joint2(x)


class SegBaselineNet(nn.Module):
    """The JAX ``_SegBaselineNet``. ``forward(x, centre, other)`` -> (N,
    out_dim) logits; ``forward(x, penultimate=True)`` -> the upsampled
    trunk features (N, 512, input_sz, input_sz), the k-means eval's."""

    def __init__(self, in_channels, patch_side, input_sz, out_dim,
                 batchnorm_track=True):
        super().__init__()
        self.patch_side = patch_side
        self.input_sz = input_sz
        self.trunk = SegmentationNet10aTrunk(in_channels, batchnorm_track)
        self.head = SiameseJointHead(self.trunk.out_channels, patch_side,
                                     out_dim, batchnorm_track)

    def forward(self, x, centre=None, other=None, penultimate=False):
        feats = F.interpolate(self.trunk(x),
                              size=(self.input_sz, self.input_sz),
                              mode="bilinear", align_corners=False)
        if penultimate:
            return feats
        if centre is None or other is None:
            raise ValueError("the patch head needs centre and other")
        return self.head(get_patches(feats, centre, self.patch_side),
                         get_patches(feats, other, self.patch_side))


def SegmentationNet10aDoersch(in_channels, patch_side, input_sz,
                              batchnorm_track=True):
    """9-way relative-position prediction."""
    return SegBaselineNet(in_channels, patch_side, input_sz, 9,
                          batchnorm_track)


def SegmentationNet10aIsola(in_channels, patch_side, input_sz,
                            batchnorm_track=True):
    """1-logit adjacency prediction."""
    return SegBaselineNet(in_channels, patch_side, input_sz, 1,
                          batchnorm_track)
