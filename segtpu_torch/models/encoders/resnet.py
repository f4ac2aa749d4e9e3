"""ResNet encoders (counterpart of segtpu/models/encoders/resnet.py):
ResNet-34 of BasicBlocks, ResNet-101 and ResNet-152 of Bottlenecks, their
output-stride-8 dilated variants, and DUC-HDC's hybrid dilation cycles.

torchvision's module names (``conv1``, ``bn1``, ``layer1..4``, blocks with
``conv1/bn1/conv2/bn2[/conv3/bn3]/downsample.{0,1}``), so a
torchvision-format state_dict loads directly. The strides, paddings,
dilations and downsample branches are segtpu's, block for block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import BatchNormTorch, Conv


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv(inplanes, planes, 1, stride=stride, bias=False),
                         BatchNormTorch(planes))


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (expansion 1); conv1 takes ``dilation``,
    conv2 ``previous_dilation`` (segtpu resnet.py:24-51)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1, previous_dilation: int = 1):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride=stride, padding=dilation,
                          dilation=dilation, bias=False)
        self.bn1 = BatchNormTorch(planes)
        self.conv2 = Conv(planes, planes, 3, padding=previous_dilation,
                          dilation=previous_dilation, bias=False)
        self.bn2 = BatchNormTorch(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual, inplace=True)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual block (expansion 4), the stride and the dilation
    on the 3x3 (segtpu resnet.py:54-89)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNormTorch(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=dilation,
                          dilation=dilation, bias=False)
        self.bn2 = BatchNormTorch(planes)
        self.conv3 = Conv(planes, out, 1, bias=False)
        self.bn3 = BatchNormTorch(out)
        self.downsample = _downsample(inplanes, out, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual, inplace=True)


class ResNetEncoder(nn.Module):
    """Feature-pyramid ResNet: ``forward`` returns (stem, e1, e2, e3, e4),
    stem = relu(bn(conv7x7 s2)) before the 3/2/1 max-pool; ``widths`` are
    e1..e4's channels.

    ``layer3_dilations`` / ``layer4_dilations``: per-block dilation cycles
    (block b takes ``dilations[b % len(dilations)]``); a layer that has one
    keeps stride 1, so the encoder's output stride is 8. In a BasicBlock
    layer with a single dilation d, the first block's conv1 takes 1 for
    d <= 2 and d // 2 for d = 4, its conv2 d (segtpu resnet.py:150-156)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), bottleneck: bool = False,
                 layer3_dilations: Optional[Sequence[int]] = None,
                 layer4_dilations: Optional[Sequence[int]] = None, num_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(num_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNormTorch(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        expansion = Bottleneck.expansion if bottleneck else BasicBlock.expansion
        self.widths = tuple(planes * expansion for planes in (64, 128, 256, 512))
        inplanes = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            dilations = {2: layer3_dilations, 3: layer4_dilations}.get(li)
            stride = 1 if li == 0 or dilations is not None else 2
            blocks = []
            for b in range(n_blocks):
                d = 1 if dilations is None else dilations[b % len(dilations)]
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes * expansion)
                if bottleneck:
                    blocks.append(Bottleneck(inplanes, planes, s, ds, dilation=d))
                else:
                    conv1_d = d
                    if dilations is not None and b == 0 and len(dilations) == 1:
                        conv1_d = 1 if d <= 2 else d // 2
                    blocks.append(BasicBlock(inplanes, planes, s, ds, dilation=conv1_d,
                                             previous_dilation=d))
                inplanes = planes * expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        stem = F.relu(self.bn1(self.conv1(x)), inplace=True)
        e1 = self.layer1(self.maxpool(stem))
        e2 = self.layer2(e1)
        e3 = self.layer3(e2)
        e4 = self.layer4(e3)
        return stem, e1, e2, e3, e4


def resnet34(dilated: bool = False, num_channels: int = 3) -> ResNetEncoder:
    """ResNet-34; ``dilated``: the stride-8 variant with dilations 2 and 4
    (DilatedLinkNet34's encoder)."""
    return ResNetEncoder((3, 4, 6, 3), layer3_dilations=(2,) if dilated else None,
                         layer4_dilations=(4,) if dilated else None, num_channels=num_channels)


def resnet101(dilated: bool = False, num_channels: int = 3) -> ResNetEncoder:
    """ResNet-101; ``dilated``: stride 8, dilations 2 and 4 (PSPNet's encoder)."""
    return ResNetEncoder((3, 4, 23, 3), bottleneck=True,
                         layer3_dilations=(2,) if dilated else None,
                         layer4_dilations=(4,) if dilated else None, num_channels=num_channels)


def resnet152(dilated: bool = False, hdc: bool = False, num_channels: int = 3) -> ResNetEncoder:
    """ResNet-152; ``dilated``: DUC's dilations 2 and 4; ``hdc``: the hybrid
    dilation cycles (1, 2, 5, 9) over layer3 and (5, 9, 17) over layer4."""
    l3 = l4 = None
    if hdc:
        l3, l4 = (1, 2, 5, 9), (5, 9, 17)
    elif dilated:
        l3, l4 = (2,), (4,)
    return ResNetEncoder((3, 8, 36, 3), bottleneck=True, layer3_dilations=l3,
                         layer4_dilations=l4, num_channels=num_channels)
