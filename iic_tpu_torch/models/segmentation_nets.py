"""Segmentation networks (``iic_tpu/models/segmentation_nets.py``).

net10a: a VGG11-style trunk of 3x3 convs, dilation 2 in the last two layers,
and multi-sub-head 1x1-conv + Softmax2d heads upsampled to the input size.
Input NCHW; output (num_sub_heads, B, K, H, W). Module names follow the
reference (``trunk.features.*``, ``head_A.heads.<s>.0.*``), so its
state_dicts load with ``load_state_dict``.
"""

import torch.nn as nn

from iic_tpu_torch.models.layers import MultiConvSoftmaxHead
from iic_tpu_torch.models.vgg import VGGTrunk

NET10A_CFG = ((64, 1), (128, 1), ("M", None), (256, 1), (256, 1),
              (512, 2), (512, 2))


class SegmentationNet10aTrunk(VGGTrunk):
    def __init__(self, in_channels, batchnorm_track=True):
        super().__init__(NET10A_CFG, in_channels, conv_size=3, pad=1,
                         batchnorm_track=batchnorm_track)


class SegmentationNet10a(nn.Module):
    """Single-head segmentation net."""

    def __init__(self, in_channels, output_k, num_sub_heads, input_sz,
                 batchnorm_track=True):
        super().__init__()
        self.trunk = SegmentationNet10aTrunk(in_channels, batchnorm_track)
        self.head = MultiConvSoftmaxHead(self.trunk.out_channels, output_k,
                                         num_sub_heads, input_sz)

    def forward(self, x):
        return self.head(self.trunk(x))


class SegmentationNet10aTwoHead(nn.Module):
    """Two-head segmentation net; ``head`` picks "A" or "B"."""

    def __init__(self, in_channels, output_k_A, output_k_B, num_sub_heads,
                 input_sz, batchnorm_track=True):
        super().__init__()
        self.trunk = SegmentationNet10aTrunk(in_channels, batchnorm_track)
        c = self.trunk.out_channels
        self.head_A = MultiConvSoftmaxHead(c, output_k_A, num_sub_heads,
                                           input_sz)
        self.head_B = MultiConvSoftmaxHead(c, output_k_B, num_sub_heads,
                                           input_sz)

    def forward(self, x, head="B"):
        if head not in ("A", "B"):
            raise ValueError(f"unknown head {head!r}")
        feats = self.trunk(x)
        return (self.head_A if head == "A" else self.head_B)(feats)
