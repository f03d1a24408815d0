"""Shared model building blocks (``iic_tpu/models/layers.py``).

BatchNorm is ``nn.BatchNorm2d(momentum=0.1, eps=1e-5)``: batch statistics
in training (with the unbiased running-variance update), running statistics
in eval when ``track_running_stats``, batch statistics always otherwise --
the JAX ``BatchNorm`` semantics. Convs get the Kaiming-normal fan-in init
with relu gain.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from iic_tpu_torch.ops.kernels.seg_joint import full_f32


def kaiming_normal_fan_in_(weight):
    """Kaiming-normal, fan-in, relu gain, untruncated."""
    return nn.init.kaiming_normal_(weight, mode="fan_in",
                                   nonlinearity="relu")


def batch_norm(features, track_running_stats=True):
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1,
                          track_running_stats=track_running_stats)


class MultiConvSoftmaxHead(nn.Module):
    """``num_sub_heads`` parallel (1x1 conv -> Softmax2d -> bilinear upsample
    to ``input_sz``) heads, the reference ``SegmentationNet10aHead``. Keeps
    its quirk: the 1x1 conv has padding=1, which adds a one-pixel ring of
    zero logits (a uniform softmax) before the upsample.

    Input (B, C, H, W) -> output (num_sub_heads, B, K, input_sz, input_sz).
    """

    def __init__(self, in_channels, output_k, num_sub_heads, input_sz):
        super().__init__()
        self.input_sz = input_sz
        self.heads = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_channels, output_k, kernel_size=1,
                                    stride=1, dilation=1, padding=1,
                                    bias=False),
                          nn.Softmax2d())
            for _ in range(num_sub_heads)])
        for head in self.heads:
            kaiming_normal_fan_in_(head[0].weight)

    def forward(self, x):
        # The JAX head is an f32 einsum at HIGHEST precision: keep the 1x1
        # conv out of TF32 whatever the trunk runs in.
        with full_f32():
            outs = [head(x) for head in self.heads]
        return torch.stack([
            F.interpolate(o, size=(self.input_sz, self.input_sz),
                          mode="bilinear", align_corners=False)
            for o in outs])
