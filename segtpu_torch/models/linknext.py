"""LinkNext (counterpart of segtpu/models/linknext.py; reference
lib/models/linknext.py:227-278): the LinkNet decoder over a from-scratch
ResNeXt-26 2x64d encoder.

``BasicBlockC`` (reference linknext.py:84-118): 1x1 -> grouped 3x3 -> 1x1
(x expansion), BatchNorm + ReLU after the first two, a 1x1 shortcut where
the shape changes, and a last BatchNorm after the residual add. Decoder
blocks end with a channel dropout of 0.1 to 0.4. segtpu's fixes to the
reference are kept: the encoder's stride-2 max-pool, and decoder1 at stride
1 with a 3x3 conv as ``deconv2``, so the output has the input's size.

Keys are the reference's: ``encoder0.{0,1}`` (stem conv, BatchNorm),
``encoder{k}.{b}.basic.{conv1_0,bn1,conv3_0,bn2,conv1_1,bn3}``,
``encoder{k}.{b}.shortcut.0``, ``encoder{k}.{b}.bn0``,
``decoder{i}.{conv1,norm1,deconv2,norm2,conv3,norm3}``, ``finaldeconv1``,
``finalconv2``, ``finalconv3``. In training mode the 45 BatchNorms run B1
and B2.

``s2d`` (segtpu linknext.py:71-90, :170-178): with even H and W, the
64-channel stem conv and its BatchNorm (grouped statistics) run in
space-to-depth form and the 3x3 stride-2 pool exits to normal space
(:func:`~segtpu_torch.ops.s2d.s2d_max_pool3_exit`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import (BatchNormTorch, Conv, ConvTranspose2dTorch, Dropout2d,
                                        float_logits, s2d_conv)
from segtpu_torch.ops.s2d import s2d, s2d_max_pool3_exit


class _BasicPath(nn.Module):
    """The residual path of :class:`BasicBlockC`, the reference's ``basic``."""

    def __init__(self, inplanes: int, inner: int, out: int, cardinality: int, stride: int):
        super().__init__()
        self.conv1_0 = Conv(inplanes, inner, 1, bias=False)
        self.bn1 = BatchNormTorch(inner)
        self.conv3_0 = Conv(inner, inner, 3, stride=stride, padding=1, groups=cardinality,
                            bias=False)
        self.bn2 = BatchNormTorch(inner)
        self.conv1_1 = Conv(inner, out, 1, bias=False)
        self.bn3 = BatchNormTorch(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1_0(x)), inplace=True)
        y = F.relu(self.bn2(self.conv3_0(y)), inplace=True)
        return self.bn3(self.conv1_1(y))


class BasicBlockC(nn.Module):
    """segtpu ``BasicBlockC``: relu(bn0(basic(x) + shortcut(x)))."""

    def __init__(self, inplanes: int, bottleneck_width: int, cardinality: int, stride: int = 1,
                 expansion: int = 2):
        super().__init__()
        inner = cardinality * bottleneck_width
        out = inner * expansion
        self.basic = _BasicPath(inplanes, inner, out, cardinality, stride)
        self.shortcut = (nn.Sequential(Conv(inplanes, out, 1, stride=stride, bias=False))
                         if stride != 1 or inplanes != out else None)
        self.bn0 = BatchNormTorch(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.bn0(self.basic(x) + sc), inplace=True)


def _stem(encoder0: nn.Sequential, x: torch.Tensor, use_s2d: bool) -> torch.Tensor:
    """The stem ``encoder0`` (conv, BatchNorm, ReLU, 3/2/1 max-pool), in s2d
    form up to its pool where ``use_s2d`` and H and W are even."""
    if not (use_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
        return encoder0(x)
    conv, bn = encoder0[0], encoder0[1]
    y = F.relu(bn(s2d_conv(conv, s2d(x)), (bn.features,)), inplace=True)
    return s2d_max_pool3_exit(y)


class ResNeXtEncoder(nn.Module):
    """ResNeXt encoder (reference linknext.py:121-158): conv3x3 stem with
    BatchNorm, ReLU and the 3/2/1 max-pool as ``encoder0``, then four layers
    ``encoder1..4`` of BasicBlockC, the bottleneck width doubling per layer;
    ``forward`` returns the four layers' outputs. ``s2d``: the stem in s2d
    form (module docstring)."""

    def __init__(self, num_blocks: Sequence[int] = (2, 2, 2, 2), cardinality: int = 2,
                 bottleneck_width: int = 64, expansion: int = 2, num_channels: int = 3,
                 s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.encoder0 = nn.Sequential(Conv(num_channels, 64, 3, padding=1), BatchNormTorch(64),
                                      nn.ReLU(inplace=True),
                                      nn.MaxPool2d(3, stride=2, padding=1))
        inplanes, bw = 64, bottleneck_width
        self.widths = []
        for li, (nb, first_stride) in enumerate(zip(num_blocks, (1, 2, 2, 2))):
            blocks = []
            for b in range(nb):
                blocks.append(BasicBlockC(inplanes, bw, cardinality,
                                          first_stride if b == 0 else 1, expansion))
                inplanes = cardinality * bw * expansion
            setattr(self, f"encoder{li + 1}", nn.Sequential(*blocks))
            self.widths.append(inplanes)
            bw *= 2

    def forward(self, x: torch.Tensor):
        e1 = self.encoder1(_stem(self.encoder0, x, self.s2d))
        e2 = self.encoder2(e1)
        e3 = self.encoder3(e2)
        return e1, e2, e3, self.encoder4(e3)


# ResNeXt-26/50 configurations (reference linknext.py:160-192)
def resnext26_2x64d(**kw):
    return ResNeXtEncoder((2, 2, 2, 2), cardinality=2, bottleneck_width=64, **kw)


def resnext26_4x32d(**kw):
    return ResNeXtEncoder((2, 2, 2, 2), cardinality=4, bottleneck_width=32, **kw)


def resnext26_8x16d(**kw):
    return ResNeXtEncoder((2, 2, 2, 2), cardinality=8, bottleneck_width=16, **kw)


def resnext26_16x8d(**kw):
    return ResNeXtEncoder((2, 2, 2, 2), cardinality=16, bottleneck_width=8, **kw)


def resnext26_32x4d(**kw):
    return ResNeXtEncoder((2, 2, 2, 2), cardinality=32, bottleneck_width=4, **kw)


def resnext50_2x64d(**kw):
    return ResNeXtEncoder((3, 4, 6, 3), cardinality=2, bottleneck_width=64, **kw)


def resnext50_32x4d(**kw):
    return ResNeXtEncoder((3, 4, 6, 3), cardinality=32, bottleneck_width=4, **kw)


class LinkNextDecoderBlock(nn.Module):
    """conv1x1 to in/4 -> deconv k4 s2 p1 (a 3x3 conv with ``stride1``) ->
    conv1x1, BatchNorm + ReLU after each, then ``Dropout2d(drop_rate)``
    (reference linknext.py:195-225)."""

    def __init__(self, in_channels: int, n_filters: int, drop_rate: float = 0.0,
                 stride1: bool = False):
        super().__init__()
        mid = in_channels // 4
        self.conv1 = Conv(in_channels, mid, 1)
        self.norm1 = BatchNormTorch(mid)
        self.deconv2 = (Conv(mid, mid, 3, padding=1) if stride1
                        else ConvTranspose2dTorch(mid, mid, 4, 2, padding=1))
        self.norm2 = BatchNormTorch(mid)
        self.conv3 = Conv(mid, n_filters, 1)
        self.norm3 = BatchNormTorch(n_filters)
        self.drop = Dropout2d(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)), inplace=True)
        y = F.relu(self.norm2(self.deconv2(y)), inplace=True)
        return self.drop(F.relu(self.norm3(self.conv3(y)), inplace=True))


class LinkNext(nn.Module):
    """reference lib/models/linknext.py:227-278; logits in fp32 (float64 for
    a float64 model). The encoder's modules sit at the top level, as the
    reference's ``encoder0..4``. ``s2d``: the encoder's stem in s2d form."""

    def __init__(self, num_classes: int = 1, num_channels: int = 3, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        enc = resnext26_2x64d(num_channels=num_channels)
        for i in range(5):
            setattr(self, f"encoder{i}", getattr(enc, f"encoder{i}"))
        f = enc.widths
        self.decoder4 = LinkNextDecoderBlock(f[3], f[2], 0.1)
        self.decoder3 = LinkNextDecoderBlock(f[2], f[1], 0.2)
        self.decoder2 = LinkNextDecoderBlock(f[1], f[0], 0.3)
        self.decoder1 = LinkNextDecoderBlock(f[0], f[0], 0.4, stride1=True)
        self.finaldeconv1 = ConvTranspose2dTorch(f[0], 32, 3, 2)
        self.finalconv2 = Conv(32, 32, 3)
        self.finalconv3 = Conv(32, num_classes, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.encoder1(_stem(self.encoder0, x, self.s2d))
        e2 = self.encoder2(e1)
        e3 = self.encoder3(e2)
        e4 = self.encoder4(e3)
        d4 = self.decoder4(e4) + e3
        d3 = self.decoder3(d4) + e2
        d2 = self.decoder2(d3) + e1
        d1 = self.decoder1(d2)
        f = F.relu(self.finaldeconv1(d1))
        f = F.relu(self.finalconv2(f))
        return float_logits(self.finalconv3(f))
