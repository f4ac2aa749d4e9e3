"""AlbuNet, plain: a U-Net with a ResNet-34 encoder and TernausNet decoder
blocks (Shvets et al., the code of arXiv:1803.01207,
github.com/ternaus/robot-surgery-segmentation ``models.py`` ``AlbuNet`` with
``is_deconv=True``), as segtpu builds it.

The encoder is torchvision's ResNet-34 under ``encoder.``: a 7x7 stride-2
stem, BatchNorm, ReLU and a 3/2/1 max pool, then ``layer1..4`` of
BasicBlocks (3/4/6/3), whose blocks are LinkNet34's
(:class:`~segbench.reference.linknet34.BasicBlock`). A ``center`` block
takes e4 pooled by 2; each decoder block is a ConvRelu (3x3 conv padded by
1, ReLU), a 4x4 stride-2 transposed conv padded by 1 and a ReLU; ``dec5``
.. ``dec2`` read the concatenation ``[decoded, skip]`` of e4 .. e1,
``dec1`` the decoded tensor alone; ``dec0`` is a ConvRelu and ``final`` a
1x1 conv to one logit per pixel. Attribute names are the state_dict keys of
both the public model and segtpu's.

Departures from the public AlbuNet, as segtpu has them:

* the stem pools with torchvision's 3x3 stride-2 max pool padded by 1; the
  public model replaces it by a 2x2 stride-2 max pool;
* the encoder has no ``avgpool`` and ``fc`` (unused in the public model's
  forward, but in its state_dict);
* the decoder is the transposed-conv variant (``is_deconv=True``); the
  public default upsamples bilinearly and runs two ConvRelus.

At the sizes the cells run (multiples of 64) every skip has its decoded
tensor's height and width, so nothing is padded before a concatenation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.linknet34 import BasicBlock
from segbench.reference.numerics import Norm, Numerics


class Encoder(nn.Module):
    """torchvision's ResNet-34 feature pyramid: ``forward`` returns e1 .. e4
    at 1/4 .. 1/32."""

    def __init__(self, nx: Numerics, num_channels: int = 3):
        super().__init__()
        self.nx = nx
        self.conv1 = nn.Conv2d(num_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = Norm(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            layer = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                layer.append(BasicBlock(nx, inplanes, planes, stride))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.nx.conv(self.conv1, x)))
        e1 = self.layer1(F.max_pool2d(x, 3, 2, 1))
        e2 = self.layer2(e1)
        e3 = self.layer3(e2)
        return e1, e2, e3, self.layer4(e3)


class ConvRelu(nn.Module):
    def __init__(self, nx: Numerics, cin: int, cout: int):
        super().__init__()
        self.nx = nx
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.nx.conv(self.conv, x))


class DecoderBlock(nn.Module):
    def __init__(self, nx: Numerics, cin: int, mid: int, cout: int):
        super().__init__()
        self.nx = nx
        self.block = nn.Sequential(ConvRelu(nx, cin, mid),
                                   nn.ConvTranspose2d(mid, cout, 4, 2, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.nx.deconv(self.block[1], self.block[0](x)))


class AlbuNet(nn.Module):
    def __init__(self, nx: Numerics, num_classes: int = 1, num_channels: int = 3,
                 num_filters: int = 32):
        super().__init__()
        self.nx = nx
        nf = num_filters
        self.encoder = Encoder(nx, num_channels)
        self.center = DecoderBlock(nx, 512, nf * 8 * 2, nf * 8)
        self.dec5 = DecoderBlock(nx, nf * 8 + 512, nf * 8 * 2, nf * 8)
        self.dec4 = DecoderBlock(nx, nf * 8 + 256, nf * 8 * 2, nf * 8)
        self.dec3 = DecoderBlock(nx, nf * 8 + 128, nf * 4 * 2, nf * 2)
        self.dec2 = DecoderBlock(nx, nf * 2 + 64, nf * 2 * 2, nf * 2 * 2)
        self.dec1 = DecoderBlock(nx, nf * 2 * 2, nf * 2 * 2, nf)
        self.dec0 = ConvRelu(nx, nf, nf)
        self.final = nn.Conv2d(nf, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1, e2, e3, e4 = self.encoder(x)
        center = self.center(F.max_pool2d(e4, 2, 2))
        dec5 = self.dec5(torch.cat([center, e4], 1))
        dec4 = self.dec4(torch.cat([dec5, e3], 1))
        dec3 = self.dec3(torch.cat([dec4, e2], 1))
        dec2 = self.dec2(torch.cat([dec3, e1], 1))
        return self.nx.conv(self.final, self.dec0(self.dec1(dec2)))
