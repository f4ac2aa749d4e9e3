"""FC-DenseNet "Tiramisu" 57/67/103 (counterpart of
segtpu/models/tiramisu.py:33-302; reference lib/models/tiramisu.py:93-205).

Dense blocks concatenate every layer's output, so each dense layer
normalises a concatenation whose width grows by the growth rate: on CUDA,
in training mode, each of its BatchNorms runs B1 forward and backward and
B2 for its affine (tiramisu67: 60 BatchNorms, so B1 120 and B2 60 launches
per step). ``remat=True`` runs each dense block through
:func:`layers.remat` in training, recomputing its activations in the
backward pass (segtpu's per-block ``nn.remat``); the running statistics are
updated once.

Attribute names are the reference's state_dict keys: ``firstconv``,
``denseBlocksDown.{i}.layers.{j}.norm/conv``, ``transDownBlocks.{i}.norm/conv``,
``bottleneck.bottleneck.layers.{j}``, ``transUpBlocks.{i}.convTrans``,
``denseBlocksUp.{i}.layers.{j}``, ``finalConv``.

Not ported: segtpu's ``packed`` growth and ``remat_policy="conv_in"``
(ROADMAP.md A18), and s2d execution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import (BatchNormTorch, Conv, ConvTranspose2dTorch, Dropout2d,
                                        float_logits, max_pool, remat)


class DenseLayer(nn.Module):
    """BN -> ReLU -> conv3x3 -> Dropout2d(0.2) (reference tiramisu.py:9-19):
    ``growth_rate`` new channels."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.norm = BatchNormTorch(in_channels)
        self.conv = Conv(in_channels, growth_rate, 3, padding=1)
        self.drop = Dropout2d(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.conv(F.relu(self.norm(x), inplace=True)))


class DenseBlock(nn.Module):
    """Concatenative growth (reference tiramisu.py:22-44): each layer reads
    the block's input and every earlier layer's output. Returns the input
    and all new features, or with ``upsample=True`` the new features only."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int, upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.layers = nn.ModuleList(DenseLayer(in_channels + i * growth_rate, growth_rate)
                                    for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        new_features = []
        for layer in self.layers:
            out = layer(x)
            x = torch.cat([x, out], 1)
            new_features.append(out)
        if self.upsample:
            return torch.cat(new_features, 1)
        return x


class TransitionDown(nn.Module):
    """BN -> ReLU -> conv1x1 -> Dropout2d(0.2) -> 2x2 max pool (reference
    tiramisu.py:47-59)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = BatchNormTorch(in_channels)
        self.conv = Conv(in_channels, in_channels, 1)
        self.drop = Dropout2d(0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(self.drop(self.conv(F.relu(self.norm(x), inplace=True))))


def _center_crop(layer: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The central ``h`` x ``w`` window of an NCHW tensor, offsets floored
    (segtpu ``_center_crop``; reference tiramisu.py:86-90)."""
    y0, x0 = (layer.shape[2] - h) // 2, (layer.shape[3] - w) // 2
    return layer[:, :, y0:y0 + h, x0:x0 + w]


class TransitionUp(nn.Module):
    """ConvTranspose2d(k3, s2), center-cropped to the skip, then
    ``cat([up, skip], 1)`` (reference tiramisu.py:62-73)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.convTrans = ConvTranspose2dTorch(in_channels, out_channels, 3, 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = _center_crop(self.convTrans(x), skip.shape[2], skip.shape[3])
        return torch.cat([up, skip], 1)


class Bottleneck(nn.Module):
    """The reference's ``Bottleneck`` Sequential: one upsampling dense block
    under ``bottleneck``."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int):
        super().__init__()
        self.bottleneck = DenseBlock(in_channels, growth_rate, n_layers, upsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneck(x)


class FCDenseNet(nn.Module):
    """reference FCDenseNet (tiramisu.py:93-205; segtpu ``FCDenseNet``):
    first conv, down path of dense blocks and transitions, bottleneck, up
    path whose blocks return only their new features except the last, and a
    1x1 head. ``remat``: per-dense-block rematerialisation in training."""

    def __init__(self, in_channels: int = 3, down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5), bottleneck_layers: int = 5,
                 growth_rate: int = 16, out_chans_first_conv: int = 48, n_classes: int = 12,
                 remat: bool = False, packed: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        if packed or remat_policy is not None:
            raise NotImplementedError(
                "FCDenseNet: packed growth and remat_policy are not yet ported to segtpu_torch: "
                "they wait for A18 of ROADMAP.md (tiramisu packed growth and remat_policy)")
        self.remat = remat
        self.firstconv = Conv(in_channels, out_chans_first_conv, 3, padding=1)
        cur, skips = out_chans_first_conv, []
        self.denseBlocksDown, self.transDownBlocks = nn.ModuleList(), nn.ModuleList()
        for n in down_blocks:
            self.denseBlocksDown.append(DenseBlock(cur, growth_rate, n))
            cur += growth_rate * n
            skips.insert(0, cur)
            self.transDownBlocks.append(TransitionDown(cur))
        self.bottleneck = Bottleneck(cur, growth_rate, bottleneck_layers)
        prev = growth_rate * bottleneck_layers
        self.transUpBlocks, self.denseBlocksUp = nn.ModuleList(), nn.ModuleList()
        for i, n in enumerate(up_blocks):
            last = i == len(up_blocks) - 1
            self.transUpBlocks.append(TransitionUp(prev, prev))
            cur = prev + skips[i]
            self.denseBlocksUp.append(DenseBlock(cur, growth_rate, n, upsample=not last))
            prev = growth_rate * n
        self.finalConv = Conv(cur + prev, n_classes, 1)

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(block, x)
        return block(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.firstconv(x)
        skips = []
        for dense, down in zip(self.denseBlocksDown, self.transDownBlocks):
            out = self._block(dense, out)
            skips.append(out)
            out = down(out)
        out = self._block(self.bottleneck, out)
        for up, dense in zip(self.transUpBlocks, self.denseBlocksUp):
            out = self._block(dense, up(out, skips.pop()))
        return float_logits(self.finalConv(out))


def FCDenseNet57(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(4,) * 5, up_blocks=(4,) * 5, bottleneck_layers=4,
                      growth_rate=12, out_chans_first_conv=48, n_classes=n_classes, **kw)


def FCDenseNet67(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(5,) * 5, up_blocks=(5,) * 5, bottleneck_layers=5,
                      growth_rate=16, out_chans_first_conv=48, n_classes=n_classes, **kw)


def FCDenseNet103(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(4, 5, 7, 10, 12), up_blocks=(12, 10, 7, 5, 4),
                      bottleneck_layers=15, growth_rate=16, out_chans_first_conv=48,
                      n_classes=n_classes, **kw)
