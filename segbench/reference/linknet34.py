"""LinkNet34, plain (Chaurasia & Culurciello, arXiv:1707.03718; reference
lib/models/linknet.py:33-90).

ResNet-34 encoder (torchvision's BasicBlocks, 3/4/6/3, stride-2 7x7 stem
and a 3/2/1 max pool, BatchNorm + ReLU), four decoder blocks (1x1 conv to
in/4, a 4x4 stride-2 transposed conv, 1x1 conv, each followed by an
InPlaceABN: BatchNorm then LeakyReLU 0.01) joined to the encoder by additive
skips, and a head: Dropout2d(0.5), a 3x3 stride-2 transposed conv,
LeakyReLU, a VALID 3x3 conv, LeakyReLU, a 2x2 conv padded by 1 to one logit
per pixel. Attribute names are the reference's state_dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.numerics import Norm, Numerics

SLOPE = 0.01


class BasicBlock(nn.Module):
    def __init__(self, nx: Numerics, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.nx = nx
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = Norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = Norm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            Norm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nx = self.nx
        y = F.relu(self.bn1(nx.conv(self.conv1, x)))
        y = self.bn2(nx.conv(self.conv2, y))
        r = x if self.downsample is None else self.downsample[1](
            nx.conv(self.downsample[0], x))
        return F.relu(y + r)


class Decoder(nn.Module):
    def __init__(self, nx: Numerics, cin: int, cout: int):
        super().__init__()
        self.nx = nx
        mid = cin // 4
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.abn1 = Norm(mid, count=False, slope=SLOPE)
        self.deconv2 = nn.ConvTranspose2d(mid, mid, 4, 2, padding=1)
        self.abn2 = Norm(mid, count=False, slope=SLOPE)
        self.conv3 = nn.Conv2d(mid, cout, 1)
        self.abn3 = Norm(cout, count=False, slope=SLOPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nx = self.nx
        y = self.abn1(nx.conv(self.conv1, x))
        y = self.abn2(nx.deconv(self.deconv2, y))
        return self.abn3(nx.conv(self.conv3, y))


class LinkNet34(nn.Module):
    def __init__(self, nx: Numerics, num_channels: int = 3, num_classes: int = 1):
        super().__init__()
        self.nx = nx
        self.firstconv = nn.Conv2d(num_channels, 64, 7, 2, 3, bias=False)
        self.firstbn = Norm(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            layer = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                layer.append(BasicBlock(nx, inplanes, planes, stride))
                inplanes = planes
            setattr(self, f"encoder{i + 1}", nn.Sequential(*layer))
        self.decoder4 = Decoder(nx, 512, 256)
        self.decoder3 = Decoder(nx, 256, 128)
        self.decoder2 = Decoder(nx, 128, 64)
        self.decoder1 = Decoder(nx, 64, 64)
        self.finaldeconv1 = nn.ConvTranspose2d(64, 32, 3, 2)
        self.finalconv2 = nn.Conv2d(32, 32, 3)
        self.finalconv3 = nn.Conv2d(32, num_classes, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nx = self.nx
        x = F.relu(self.firstbn(nx.conv(self.firstconv, x)))
        e1 = self.encoder1(F.max_pool2d(x, 3, 2, 1))
        e2 = self.encoder2(e1)
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)
        d4 = self.decoder4(e4) + e3
        d3 = self.decoder3(d4) + e2
        d2 = self.decoder2(d3) + e1
        d1 = self.decoder1(d2)
        f = nx.dropout2d(d1, 0.5, self.training)
        f = F.leaky_relu(nx.deconv(self.finaldeconv1, f), SLOPE)
        f = F.leaky_relu(nx.conv(self.finalconv2, f), SLOPE)
        return nx.conv(self.finalconv3, f)

