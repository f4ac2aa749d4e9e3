"""LinkNet34 and DilatedLinkNet34 (counterpart of segtpu/models/linknet.py;
reference lib/models/linknet.py, dilated_linknet.py): ResNet-34 encoder,
1x1 -> deconv(k4, s2) -> 1x1 decoder blocks with InPlaceABN, additive
skips, deconv + LeakyReLU head.

DilatedLinkNet34 is segtpu's fixed variant of the reference's: the
stride-8 dilated ResNet-34, plain BatchNorm + ReLU in the decoders (keys
``decoder{i}.norm1..3``), decoder4 and decoder3 at stride 1 with a 3x3
conv as ``deconv2`` (so that the additive skips align), and a ReLU head
with no dropout. Its 48 BatchNorms run B1 and B2 in training mode.

Attribute names are the reference's state_dict keys: ``firstconv``,
``firstbn``, ``encoder1..4``, ``decoder{i}.conv1/abn1/deconv2/abn2/conv3/abn3``,
``finaldeconv1``, ``finalconv2``, ``finalconv3``. On CUDA the twelve
InPlaceABN layers of the decoder run the B2 kernel; in training mode they
and the 36 BatchNorms of the encoder take their batch statistics from B1,
the BatchNorm backward runs B1 and the InPlaceABN backward B3.
``finaldrop1`` is ``layers.Dropout2d(0.5)`` (torch's channel dropout,
training mode only).

``s2d`` (LinkNet34 only, as segtpu's; segtpu linknet.py:68-117): where the
head's transposed conv gives odd H and W (513 at patch 512), the VALID 3x3
``finalconv2`` runs as a SAME conv in s2d form over the input padded to
even size, and the rows and columns that touch the padding are cut off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.encoders.resnet import resnet34
from segtpu_torch.models.layers import (BatchNormTorch, Conv, ConvTranspose2dTorch, Dropout2d,
                                        InPlaceABN, float_logits, s2d_conv)
from segtpu_torch.ops.s2d import d2s, s2d


class DecoderBlockLinkNet(nn.Module):
    """conv1x1 to in/4 -> deconv k4 s2 p1 -> conv1x1 to n_filters, each
    followed by InPlaceABN (reference linknet.py:5-30). ``plain_bn``:
    BatchNorm + ReLU instead, as ``norm1..3`` (dilated_linknet.py:10-39);
    ``stride1``: a 3x3 conv in place of the deconv (segtpu
    linknet.py:28-58)."""

    def __init__(self, in_channels: int, n_filters: int, plain_bn: bool = False,
                 stride1: bool = False):
        super().__init__()
        mid = in_channels // 4
        self.plain_bn = plain_bn
        norm = BatchNormTorch if plain_bn else InPlaceABN
        prefix = "norm" if plain_bn else "abn"
        self.conv1 = Conv(in_channels, mid, 1)
        setattr(self, f"{prefix}1", norm(mid))
        self.deconv2 = (Conv(mid, mid, 3, padding=1) if stride1
                        else ConvTranspose2dTorch(mid, mid, 4, 2, padding=1))
        setattr(self, f"{prefix}2", norm(mid))
        self.conv3 = Conv(mid, n_filters, 1)
        setattr(self, f"{prefix}3", norm(n_filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.plain_bn:
            y = F.relu(self.norm1(self.conv1(x)), inplace=True)
            y = F.relu(self.norm2(self.deconv2(y)), inplace=True)
            return F.relu(self.norm3(self.conv3(y)), inplace=True)
        y = self.abn1(self.conv1(x))
        y = self.abn2(self.deconv2(y))
        return self.abn3(self.conv3(y))


class LinkNet34(nn.Module):
    """reference lib/models/linknet.py:33-90; logits in fp32 (float64 for a
    float64 model, a CPU reference run). ``plain_bn`` and ``dilated`` as
    segtpu's LinkNet34: DilatedLinkNet34 sets both, and has no ``s2d``
    attribute, as segtpu's DilatedLinkNet34 has no s2d mode."""

    def __init__(self, num_classes: int = 1, num_channels: int = 3, plain_bn: bool = False,
                 dilated: bool = False, s2d: bool = False):
        super().__init__()
        if dilated:
            if s2d:
                raise ValueError("the dilated LinkNet34 has no s2d mode")
        else:
            self.s2d = s2d
        self.dilated = dilated
        filters = (64, 128, 256, 512)
        enc = resnet34(dilated=dilated, num_channels=num_channels)
        self.firstconv = enc.conv1
        self.firstbn = enc.bn1
        self.firstmaxpool = enc.maxpool
        self.encoder1 = enc.layer1
        self.encoder2 = enc.layer2
        self.encoder3 = enc.layer3
        self.encoder4 = enc.layer4

        # the stride-8 encoder: no upsampling in the deep decoders
        self.decoder4 = DecoderBlockLinkNet(filters[3], filters[2], plain_bn, stride1=dilated)
        self.decoder3 = DecoderBlockLinkNet(filters[2], filters[1], plain_bn, stride1=dilated)
        self.decoder2 = DecoderBlockLinkNet(filters[1], filters[0], plain_bn)
        self.decoder1 = DecoderBlockLinkNet(filters[0], filters[0], plain_bn)

        # the dilated variant has no dropout and a ReLU head (dilated_linknet.py:66-72, 94)
        self.finaldrop1 = None if dilated else Dropout2d(0.5)
        self.finaldeconv1 = ConvTranspose2dTorch(filters[0], 32, 3, 2)
        self.finalconv2 = Conv(32, 32, 3)
        self.finalconv3 = Conv(32, num_classes, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.firstbn(self.firstconv(x)), inplace=True)
        e1 = self.encoder1(self.firstmaxpool(x))
        e2 = self.encoder2(e1)
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)

        # additive skips (reference linknet.py:77-79)
        d4 = self.decoder4(e4) + e3
        d3 = self.decoder3(d4) + e2
        d2 = self.decoder2(d3) + e1
        d1 = self.decoder1(d2)

        if self.dilated:
            f = F.relu(self.finaldeconv1(d1))
            f = F.relu(self.finalconv2(f))
        else:
            f = F.leaky_relu(self.finaldeconv1(self.finaldrop1(d1)), 0.01)
            h, w = f.shape[2:]
            if self.s2d and h % 2 == 1 and w % 2 == 1:
                g = d2s(s2d_conv(self.finalconv2, s2d(F.pad(f, (0, 1, 0, 1)))))
                f = g[:, :, 1:h - 1, 1:w - 1]
            else:
                f = self.finalconv2(f)
            f = F.leaky_relu(f, 0.01)
        return float_logits(self.finalconv3(f))


def DilatedLinkNet34(num_classes: int = 1, num_channels: int = 3) -> LinkNet34:
    """reference dilated_linknet.py:42-99, as segtpu fixes it (module docstring)."""
    return LinkNet34(num_classes=num_classes, num_channels=num_channels, plain_bn=True,
                     dilated=True)
