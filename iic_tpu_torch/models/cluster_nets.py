"""Clustering networks (``iic_tpu/models/cluster_nets.py``): the ResNet-34
``ClusterNet5g`` family and the VGG-style ``ClusterNet6c`` family.

Input NCHW; output (num_sub_heads, B, K) softmax probabilities. Two-head
nets dispatch on ``head="A"|"B"``; built with ``semisup``, their head B is
one bare Linear that returns (B, output_k_B) logits. ``trunk_features``
returns the trunk's features instead of a head's output, and
``penultimate_features`` (the ResNets only) the features before layer4:
layer3's output flattened in NCHW order. ``TripletsNet`` is the triplets
baseline's net: either trunk and one Linear, no softmax. Module names
follow the reference
(``trunk.conv1``, ``trunk.layer1.0.conv1``, ``trunk.features.<i>``,
``head_A.heads.<s>.0``), so its state_dicts load with
``load_state_dict``. ``dtype`` is the trunk's compute dtype (see
``layers``); the ResNet's spatial mean is taken in f32, as the JAX trunk
takes it, and the heads run in f32.
"""

import torch
import torch.nn as nn

from iic_tpu_torch.models.layers import (
    Conv2d, MultiDenseHead, batch_norm, kaiming_normal_fan_out_,
    linear_init_, max_pool_2x2_pad1)
from iic_tpu_torch.models.residual import BasicBlock, ResNetLayer
from iic_tpu_torch.models.vgg import VGGTrunk

# (planes, blocks, stride) of ResNet-34's four layers
LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
# (out_channels, dilation) | ("M", None): the reference's net6c cfg
NET6C_CFG = ((64, 1), ("M", None), (128, 1), ("M", None),
             (256, 1), ("M", None), (512, 1))


class ClusterNet6cTrunk(VGGTrunk):
    """Four 5x5 convs with padding 2, each with BN and relu, max-pools 2x2
    between them, then the features flattened in NCHW order, (B, 512 * s *
    s) with s = input_sz // 8. The JAX trunk runs NHWC and flattens through
    ``flatten_nhwc_as_nchw``; on NCHW tensors that order is a plain
    ``flatten(1)``."""

    def __init__(self, in_channels, batchnorm_track=True,
                 dtype=torch.float32):
        super().__init__(NET6C_CFG, in_channels, conv_size=5, pad=2,
                         batchnorm_track=batchnorm_track, dtype=dtype)

    def forward(self, x):
        return self.features(x).flatten(1)


def _net6c_features(input_sz):
    """Width of ClusterNet6cTrunk's flattened features at ``input_sz``."""
    side = input_sz
    for out, _ in NET6C_CFG:
        if out == "M":
            side //= 2
    return NET6C_CFG[-1][0] * side * side


def _two_heads(net, d, output_k_A, output_k_B, num_sub_heads, semisup):
    """head_A, and head_B: sub-heads as head_A's, or under ``semisup`` one
    Linear(d, output_k_B) with the N(0, 0.01) init and no softmax."""
    net.semisup = semisup
    net.head_A = MultiDenseHead(d, output_k_A, num_sub_heads)
    net.head_B = (linear_init_(nn.Linear(d, output_k_B)) if semisup
                  else MultiDenseHead(d, output_k_B, num_sub_heads))


def _check_head(head):
    if head not in ("A", "B"):
        raise ValueError(f"unknown head {head!r}")


def _head_out(net, feats, head):
    """The output of ``head``; the semisup head B's logits in f32."""
    if head == "B" and net.semisup:
        return net.head_B(feats.float())
    return (net.head_A if head == "A" else net.head_B)(feats)


def _net6c_trunk(net, x, penultimate_features):
    if penultimate_features:
        raise ValueError("penultimate_features is not implemented for "
                         "net6c (the reference asserts it is not set)")
    return net.trunk(x)


class ClusterNet6c(nn.Module):
    """Single-head net6c."""

    def __init__(self, in_channels, output_k, num_sub_heads, input_sz,
                 batchnorm_track=True, dtype=torch.float32):
        super().__init__()
        self.trunk = ClusterNet6cTrunk(in_channels, batchnorm_track, dtype)
        self.head = MultiDenseHead(_net6c_features(input_sz), output_k,
                                   num_sub_heads)

    def forward(self, x, trunk_features=False, penultimate_features=False):
        feats = _net6c_trunk(self, x, penultimate_features)
        return feats if trunk_features else self.head(feats)


class ClusterNet6cTwoHead(nn.Module):
    """Two-head net6c; ``head`` picks "A" or "B"."""

    def __init__(self, in_channels, output_k_A, output_k_B, num_sub_heads,
                 input_sz, semisup=False, batchnorm_track=True,
                 dtype=torch.float32):
        super().__init__()
        self.trunk = ClusterNet6cTrunk(in_channels, batchnorm_track, dtype)
        _two_heads(self, _net6c_features(input_sz), output_k_A, output_k_B,
                   num_sub_heads, semisup)

    def forward(self, x, head="B", trunk_features=False,
                penultimate_features=False):
        _check_head(head)
        feats = _net6c_trunk(self, x, penultimate_features)
        return feats if trunk_features else _head_out(self, feats, head)


class ClusterNet5gTrunk(nn.Module):
    """3x3 stem at stride 1, BN, relu, max-pool 2 with padding 1, layers
    [3, 4, 6, 3], then the spatial mean (the reference's AvgPool2d sized to
    the final feature map) -> (B, 512)."""

    def __init__(self, in_channels, batchnorm_track=True,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, kernel_size=3, stride=1,
                            padding=1, bias=False, compute_dtype=dtype)
        kaiming_normal_fan_out_(self.conv1.weight)
        self.bn1 = batch_norm(64, batchnorm_track)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = max_pool_2x2_pad1()
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(LAYERS):
            self.add_module(f"layer{i + 1}", ResNetLayer(
                inplanes, planes, blocks, stride, batchnorm_track, dtype))
            inplanes = planes * BasicBlock.expansion
        self.out_channels = inplanes

    def forward(self, x, penultimate_features=False):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        if penultimate_features:
            return x.flatten(1)  # (B, 256 * s * s), s = input_sz // 8 + 1
        # the mean in the parameters' dtype (f32) whatever the compute dtype
        return self.layer4(x).to(self.bn1.weight.dtype).mean(dim=(2, 3))


class ClusterNet5g(nn.Module):
    """Single-head ResNet-34 cluster net."""

    def __init__(self, in_channels, output_k, num_sub_heads,
                 batchnorm_track=True, dtype=torch.float32):
        super().__init__()
        self.trunk = ClusterNet5gTrunk(in_channels, batchnorm_track, dtype)
        self.head = MultiDenseHead(self.trunk.out_channels, output_k,
                                   num_sub_heads)

    def forward(self, x, trunk_features=False, penultimate_features=False):
        feats = self.trunk(x, penultimate_features)
        return feats if trunk_features else self.head(feats)


class ClusterNet5gTwoHead(nn.Module):
    """Two-head ResNet-34 cluster net; ``head`` picks "A" or "B"."""

    def __init__(self, in_channels, output_k_A, output_k_B, num_sub_heads,
                 semisup=False, batchnorm_track=True, dtype=torch.float32):
        super().__init__()
        self.trunk = ClusterNet5gTrunk(in_channels, batchnorm_track, dtype)
        _two_heads(self, self.trunk.out_channels, output_k_A, output_k_B,
                   num_sub_heads, semisup)

    def forward(self, x, head="B", trunk_features=False,
                penultimate_features=False):
        _check_head(head)
        feats = self.trunk(x, penultimate_features)
        return feats if trunk_features else _head_out(self, feats, head)


class TripletsNet(nn.Module):
    """The triplets baseline: the ResNet-34 trunk (``trunk_type`` "5g") or
    net6c's (``"6c"``) and one Linear(d, output_k) with the N(0, 0.01)
    init, no softmax; (B, output_k) logits in the head's dtype (f32).
    ``kmeans_use_features``
    returns the trunk's features instead (f32 for the ResNet's spatial
    mean, the compute dtype for net6c's flattened map)."""

    def __init__(self, in_channels, output_k, input_sz, trunk_type="5g",
                 batchnorm_track=True, dtype=torch.float32):
        super().__init__()
        if trunk_type == "5g":
            self.trunk = ClusterNet5gTrunk(in_channels, batchnorm_track,
                                           dtype)
            d = self.trunk.out_channels
        elif trunk_type == "6c":
            self.trunk = ClusterNet6cTrunk(in_channels, batchnorm_track,
                                           dtype)
            d = _net6c_features(input_sz)
        else:
            raise ValueError(f"unknown trunk_type {trunk_type!r}")
        self.head = linear_init_(nn.Linear(d, output_k))

    def forward(self, x, kmeans_use_features=False):
        feats = self.trunk(x)
        if kmeans_use_features:
            return feats
        return self.head(feats.to(self.head.weight.dtype))
