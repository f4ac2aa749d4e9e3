"""ResNet-34 encoder (counterpart of segtpu/models/encoders/resnet.py).

torchvision's module names (``conv1``, ``bn1``, ``layer1..4``, blocks with
``conv1/bn1/conv2/bn2/downsample.{0,1}``), so a torchvision-format state_dict
loads directly. Only the plain (stride-32) ResNet-34 of LinkNet34 is ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import BatchNormTorch, Conv


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (expansion 1)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNormTorch(planes)
        self.conv2 = Conv(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNormTorch(planes)
        self.downsample = (nn.Sequential(Conv(inplanes, planes, 1, stride=stride, bias=False),
                                         BatchNormTorch(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual, inplace=True)


class ResNetEncoder(nn.Module):
    """Feature-pyramid ResNet of BasicBlocks: ``forward`` returns
    (stem, e1, e2, e3, e4), stem = relu(bn(conv7x7 s2)) before the 3/2/1
    max-pool."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(num_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNormTorch(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                blocks.append(BasicBlock(inplanes, planes, s,
                                         downsample=b == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        stem = F.relu(self.bn1(self.conv1(x)), inplace=True)
        e1 = self.layer1(self.maxpool(stem))
        e2 = self.layer2(e1)
        e3 = self.layer3(e2)
        e4 = self.layer4(e3)
        return stem, e1, e2, e3, e4


def resnet34(dilated: bool = False, num_channels: int = 3) -> ResNetEncoder:
    if dilated:
        raise NotImplementedError("the dilated ResNet-34 (dilated_linknet34) is not yet ported")
    return ResNetEncoder((3, 4, 6, 3), num_channels=num_channels)
