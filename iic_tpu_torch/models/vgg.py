"""Cfg-driven VGG trunk (``iic_tpu/models/vgg.py``).

cfg entries are (out_channels, dilation) or ("M", None) / ("A", None) for
max / avg pool 2x2. Convs are bias-free, stride 1, padding ``pad``, each
followed by BatchNorm + ReLU. The layers sit in ``features`` as in the
reference, so its state_dict keys (``features.<i>.*``) line up. The convs
run in ``dtype`` (see ``layers``), and so do the activations they make.
"""

import torch
import torch.nn as nn

from iic_tpu_torch.models.layers import (
    Conv2d, batch_norm, kaiming_normal_fan_in_)


class VGGTrunk(nn.Module):
    def __init__(self, cfg, in_channels, conv_size, pad,
                 batchnorm_track=True, dtype=torch.float32):
        super().__init__()
        layers = []
        for out, dilation in cfg:
            if out == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
            elif out == "A":
                layers.append(nn.AvgPool2d(kernel_size=2, stride=2))
            else:
                conv = Conv2d(in_channels, out, kernel_size=conv_size,
                              stride=1, padding=pad, dilation=dilation,
                              bias=False, compute_dtype=dtype)
                kaiming_normal_fan_in_(conv.weight)
                layers += [conv, batch_norm(out, batchnorm_track),
                           nn.ReLU(inplace=True)]
                in_channels = out
        self.features = nn.Sequential(*layers)
        self.out_channels = in_channels

    def forward(self, x):
        return self.features(x)
