"""TernausNet: UNet11 (VGG11 encoder) and UNet16 (VGG16 encoder)
(counterpart of segtpu/models/ternaus.py; reference lib/models/unet11.py:51-122,
unet16.py:52-131). NCHW. Logits in fp32 (float64 for a float64 model, a
CPU reference run).

``s2d`` (segtpu ternaus.py:20-190; its form of ``unet11-finetune-512``):
with even H and W, ``conv1`` runs in space-to-depth form and exits through
:func:`~segtpu_torch.ops.s2d.s2d_max_pool_exit`, ``dec2``'s transposed conv
emits the s2d form of its output directly (:func:`layers.deconv_s2d`),
``dec1`` reads the block-wise concat ``[dec2 | conv1]`` through an
input-permuted expanded kernel, and the 1x1 head converts once at the end.
Same modules and ``state_dict`` as normal space.

Attribute names are the reference's state_dict keys: the VGG stages
``conv1`` .. ``conv5`` are Sequentials of (conv, ReLU) pairs, so their convs
sit at indices 0, 2, 4; ``center`` and ``dec5`` .. ``dec2`` hold
``block.0.conv`` (the ConvRelu) and ``block.1`` (the transposed conv);
``dec1.conv``; ``final``. No normalisation layer, so no kernel of this repo
runs in these models: the step is cuDNN convolutions, transposed
convolutions and ReLU.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from segtpu_torch.models.layers import (Conv, ConvTranspose2dTorch, deconv_s2d, float_logits,
                                        max_pool, s2d_conv)
from segtpu_torch.ops.s2d import blocked_perm, d2s, s2d, s2d_max_pool_exit


class ConvRelu(nn.Module):
    """conv3x3 (padding 1) + ReLU (reference unet11.py:12-21)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x))


class DecoderBlock(nn.Module):
    """ConvRelu -> ConvTranspose2d(k4, s2, p1) -> ReLU (reference
    unet11.py:23-48): doubles H and W."""

    def __init__(self, in_channels: int, middle_channels: int, out_channels: int):
        super().__init__()
        self.block = nn.Sequential(ConvRelu(in_channels, middle_channels),
                                   ConvTranspose2dTorch(middle_channels, out_channels, 4, 2,
                                                        padding=1),
                                   nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


def vgg_stage(in_channels: int, widths: Sequence[int]) -> nn.Sequential:
    """One VGG stage, pooling excluded: conv3x3 + ReLU for each width, the
    convs at indices 0, 2, 4 (segtpu ``_VGGConvs``)."""
    mods = []
    for w in widths:
        mods += [Conv(in_channels, w, 3, padding=1), nn.ReLU(inplace=True)]
        in_channels = w
    return nn.Sequential(*mods)


class _TernausNet(nn.Module):
    """The U-Net of UNet11 and UNet16: five VGG stages, a pooled center, five
    decoder blocks with concatenated skips ``[decoded, skip]``, a ConvRelu and
    a 1x1 head. H and W must be multiples of 32."""

    STAGES: Sequence[Sequence[int]] = ()
    DEC4_OUT = 4  # dec4's output channels in units of num_filters

    def __init__(self, num_classes: int = 1, num_filters: int = 32, num_channels: int = 3,
                 s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        nf, cin = num_filters, num_channels
        for i, widths in enumerate(self.STAGES):
            setattr(self, f"conv{i + 1}", vgg_stage(cin, widths))
            cin = widths[-1]
        c1, c2, c3, c4, c5 = (widths[-1] for widths in self.STAGES)
        d4 = nf * self.DEC4_OUT
        self.center = DecoderBlock(c5, nf * 8 * 2, nf * 8)
        self.dec5 = DecoderBlock(nf * 8 + c5, nf * 8 * 2, nf * 8)
        self.dec4 = DecoderBlock(nf * 8 + c4, nf * 8 * 2, d4)
        self.dec3 = DecoderBlock(d4 + c3, nf * 4 * 2, nf * 2)
        self.dec2 = DecoderBlock(nf * 2 + c2, nf * 2 * 2, nf)
        self.dec1 = ConvRelu(nf + c1, nf)
        self.final = Conv(nf, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            return self._forward_s2d(x)
        conv1 = self.conv1(x)
        conv2 = self.conv2(max_pool(conv1))
        conv3 = self.conv3(max_pool(conv2))
        conv4 = self.conv4(max_pool(conv3))
        conv5 = self.conv5(max_pool(conv4))
        center = self.center(max_pool(conv5))
        dec5 = self.dec5(torch.cat([center, conv5], 1))
        dec4 = self.dec4(torch.cat([dec5, conv4], 1))
        dec3 = self.dec3(torch.cat([dec4, conv3], 1))
        dec2 = self.dec2(torch.cat([dec3, conv2], 1))
        dec1 = self.dec1(torch.cat([dec2, conv1], 1))
        return float_logits(self.final(dec1))

    def _forward_s2d(self, x: torch.Tensor) -> torch.Tensor:
        conv1s = s2d(x)
        for m in self.conv1[0::2]:
            conv1s = torch.relu(s2d_conv(m, conv1s))
        conv2 = self.conv2(s2d_max_pool_exit(conv1s))
        conv3 = self.conv3(max_pool(conv2))
        conv4 = self.conv4(max_pool(conv3))
        conv5 = self.conv5(max_pool(conv4))
        center = self.center(max_pool(conv5))
        dec5 = self.dec5(torch.cat([center, conv5], 1))
        dec4 = self.dec4(torch.cat([dec5, conv4], 1))
        dec3 = self.dec3(torch.cat([dec4, conv3], 1))
        convrelu, deconv = self.dec2.block[0], self.dec2.block[1]
        dec2s = torch.relu(deconv_s2d(deconv, convrelu(torch.cat([dec3, conv2], 1))))
        perm = blocked_perm((dec2s.shape[1] // 4, conv1s.shape[1] // 4))
        dec1s = torch.relu(s2d_conv(self.dec1.conv, torch.cat([dec2s, conv1s], 1), in_perm=perm))
        return float_logits(d2s(s2d_conv(self.final, dec1s)))


class UNet11(_TernausNet):
    """reference lib/models/unet11.py:51-122 (segtpu ``UNet11``)."""

    STAGES = ((64,), (128,), (256, 256), (512, 512), (512, 512))
    DEC4_OUT = 4


class UNet16(_TernausNet):
    """reference lib/models/unet16.py:52-131 (segtpu ``UNet16``)."""

    STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
    DEC4_OUT = 8
