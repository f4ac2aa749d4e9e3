"""ZF_UNET_224, plain (a U-Net, Ronneberger et al., arXiv:1505.04597, as
ZFTurbo's ZF_UNET_224 builds it; reference lib/models/zf_unet.py:35-95).

Six levels of widths 32, 64, ..., 1024. Each block is (3x3 conv, BatchNorm,
ReLU) twice, then Dropout2d(0.2). Going down, a 2x2 max pool between
levels; going up, nearest upsampling by 2 and the concatenation
``[upsampled, skip]``, then a block; a 1x1 head. Attribute names are the
reference's state_dict keys.

Departures from the published model: the Keras original ends in a sigmoid,
which the losses here take from the logits instead; its BatchNorms use
Keras's momentum 0.99 and eps 1e-3, those of the reference benchmark's
PyTorch port torch's 0.1 and 1e-5, which are kept here. The space-to-depth
form of the program runs the same math in another layout, so this one
reference checks both forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.numerics import Norm, Numerics

DROP = 0.2
LEVELS = ("224", "112", "56", "28", "14", "7")


class ConvBNReLU(nn.Module):
    def __init__(self, nx: Numerics, cin: int, cout: int):
        super().__init__()
        self.nx = nx
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn = Norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.nx.conv(self.conv, x)))


class DoubleConv(nn.Module):
    def __init__(self, nx: Numerics, cin: int, cout: int):
        super().__init__()
        self.nx = nx
        self.l1 = ConvBNReLU(nx, cin, cout)
        self.l2 = ConvBNReLU(nx, cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nx.dropout2d(self.l2(self.l1(x)), DROP, self.training)


class ZFUNet(nn.Module):
    def __init__(self, nx: Numerics, in_channels: int = 3, n_classes: int = 1,
                 filters: int = 32):
        super().__init__()
        self.nx = nx
        widths = [filters * 2 ** i for i in range(len(LEVELS))]
        cin = in_channels
        for level, w in zip(LEVELS, widths):
            setattr(self, f"conv_{level}", DoubleConv(nx, cin, w))
            cin = w
        for level, w in zip(LEVELS[-2::-1], widths[-2::-1]):
            setattr(self, f"up_conv_{level}", DoubleConv(nx, cin + w, w))
            cin = w
        self.conv_final = nn.Conv2d(filters, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, level in enumerate(LEVELS):
            x = getattr(self, f"conv_{level}")(x if i == 0 else F.max_pool2d(x, 2, 2))
            skips.append(x)
        for level, skip in zip(LEVELS[-2::-1], skips[-2::-1]):
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"up_conv_{level}")(torch.cat([up, skip], 1))
        return self.nx.conv(self.conv_final, x)


def ZF_UNET(nx: Numerics, in_channels: int = 3, n_classes: int = 1) -> ZFUNet:
    """ZF_UNET_224 with 32 filters at the top level."""
    return ZFUNet(nx, in_channels, n_classes, 32)
