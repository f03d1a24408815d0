"""ResNet-34-style trunk blocks (``iic_tpu/models/residual.py``).

BasicBlock: conv3x3(stride)-BN-relu-conv3x3-BN, plus a 1x1-conv-BN
downsample of the input when the stride is not 1 or the channel count
changes, residual add, relu. Bias-free convs with the Kaiming-normal
fan-out init. Module names follow the reference (``conv1``, ``bn1``,
``conv2``, ``bn2``, ``downsample.0/1``; ``ResNetLayer`` numbers its blocks
``0..n-1``), so its state_dicts load with ``load_state_dict``. The convs
run in ``dtype`` (see ``layers``), so the residual add does too, as in
the JAX blocks.
"""

import torch
import torch.nn as nn

from iic_tpu_torch.models.layers import (
    Conv2d, batch_norm, kaiming_normal_fan_out_)


def _conv(in_planes, out_planes, kernel_size, stride, dtype):
    conv = Conv2d(in_planes, out_planes, kernel_size=kernel_size,
                  stride=stride, padding=kernel_size // 2, bias=False,
                  compute_dtype=dtype)
    kaiming_normal_fan_out_(conv.weight)
    return conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, batchnorm_track=True,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype)
        self.bn1 = batch_norm(planes, batchnorm_track)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv(planes, planes, 3, 1, dtype)
        self.bn2 = batch_norm(planes, batchnorm_track)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * self.expansion, 1, stride, dtype),
                batch_norm(planes * self.expansion, batchnorm_track))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class ResNetLayer(nn.Sequential):
    """The reference's ``_make_layer``: ``blocks`` BasicBlocks, the first
    one may stride."""

    def __init__(self, inplanes, planes, blocks, stride=1,
                 batchnorm_track=True, dtype=torch.float32):
        layers = [BasicBlock(inplanes, planes, stride, batchnorm_track,
                             dtype)]
        layers += [BasicBlock(planes * BasicBlock.expansion, planes, 1,
                              batchnorm_track, dtype)
                   for _ in range(1, blocks)]
        super().__init__(*layers)
