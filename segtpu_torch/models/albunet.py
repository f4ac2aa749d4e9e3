"""AlbuNet: U-Net with a ResNet-34 encoder (counterpart of
segtpu/models/albunet.py): the torchvision ResNet-34 feature pyramid under
``encoder``, TernausNet decoder blocks (ConvRelu -> deconv k4 s2 p1 -> ReLU)
with concatenated skips at each scale, a final ConvRelu and a 1x1 head.

Attribute names: ``encoder.conv1``, ``encoder.bn1``, ``encoder.layer1..4``
(torchvision's keys under ``encoder.``), ``center``, ``dec5`` .. ``dec1``
(``block.0.conv``, ``block.1``), ``dec0.conv``, ``final``. On CUDA the 36
BatchNorms of the encoder take their batch statistics and backward sums
from B1 and their affine from B2 in training mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.encoders.resnet import resnet34
from segtpu_torch.models.layers import Conv, float_logits, max_pool
from segtpu_torch.models.ternaus import ConvRelu, DecoderBlock


def _cat_skip(up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """``cat([up, skip], 1)`` with both zero-padded to the larger H and the
    larger W, by ``(d // 2, d - d // 2)`` on each (segtpu ``_cat_skip``,
    albunet.py:27-49). Where H and W are multiples of 64 nothing is padded;
    at odd sizes either tensor may be the smaller in either dimension."""
    th, tw = max(up.shape[2], skip.shape[2]), max(up.shape[3], skip.shape[3])

    def pad_to(t):
        dh, dw = th - t.shape[2], tw - t.shape[3]
        if dh == 0 and dw == 0:
            return t
        return F.pad(t, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))

    return torch.cat([pad_to(up), pad_to(skip)], 1)


class AlbuNet(nn.Module):
    """ResNet-34-encoder U-Net (segtpu ``AlbuNet``, albunet.py:52-85). The
    encoder gives e1 .. e4 at 1/4 .. 1/32; the center pools e4 to 1/64 and
    six decoder blocks upsample back to full resolution."""

    def __init__(self, num_classes: int = 1, num_channels: int = 3, num_filters: int = 32):
        super().__init__()
        nf = num_filters
        self.encoder = resnet34(num_channels=num_channels)
        self.center = DecoderBlock(512, nf * 8 * 2, nf * 8)
        self.dec5 = DecoderBlock(nf * 8 + 512, nf * 8 * 2, nf * 8)
        self.dec4 = DecoderBlock(nf * 8 + 256, nf * 8 * 2, nf * 8)
        self.dec3 = DecoderBlock(nf * 8 + 128, nf * 4 * 2, nf * 2)
        self.dec2 = DecoderBlock(nf * 2 + 64, nf * 2 * 2, nf * 2 * 2)
        self.dec1 = DecoderBlock(nf * 2 * 2, nf * 2 * 2, nf)
        self.dec0 = ConvRelu(nf, nf)
        self.final = Conv(nf, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _stem, e1, e2, e3, e4 = self.encoder(x)
        center = self.center(max_pool(e4))
        dec5 = self.dec5(_cat_skip(center, e4))
        dec4 = self.dec4(_cat_skip(dec5, e3))
        dec3 = self.dec3(_cat_skip(dec4, e2))
        dec2 = self.dec2(_cat_skip(dec3, e1))
        dec1 = self.dec1(dec2)
        return float_logits(self.final(self.dec0(dec1)))
