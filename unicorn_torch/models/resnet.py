"""ResNet-50 backbone with GroupNorm, PyTorch (port of
unicorn_tpu/models/resnet.py).

Returns the stride-8/16/32 features of layer2..layer4 (512 / 1024 / 2048
channels). Module names are torchvision's (conv1, bn1, layer{1-4}.{i}.
{conv1,bn1,conv2,bn2,conv3,bn3}, layer{s}.0.downsample.{0,1}); every norm is
the port's GroupNorm32 (fp32 statistics, eps 1e-3). The first block of every
stage has the projection shortcut, the first stage's at stride 1 too, as in
the JAX model. There is no remat: the JAX package passes none to ResNet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d, GroupNorm32, MaxPool2d


class BottleneckRes(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each conv without bias and followed by
    GroupNorm32; the projection shortcut (1x1 at the stride + GroupNorm32)
    with `downsample`."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = GroupNorm32(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn2 = GroupNorm32(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = GroupNorm32(planes * 4, dtype=dtype)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride, bias=False, dtype=dtype),
            GroupNorm32(planes * 4, dtype=dtype)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """7x7/2 stem conv -> GroupNorm32 -> ReLU -> 3x3/2 max pool (padding
    -inf, as flax's) -> four stages of BottleneckRes (`layers` blocks
    each)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = GroupNorm32(64, dtype=dtype)
        self.maxpool = MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for i in range(layers[stage]):
                blocks.append(BottleneckRes(
                    inplanes, planes, stride=2 if stage and not i else 1,
                    downsample=i == 0, dtype=dtype))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage >= 1:
                outs.append(x)
        return tuple(outs)  # strides 8, 16, 32


RESNET_OUT_CHANNELS = {"resnet50": (512, 1024, 2048)}
