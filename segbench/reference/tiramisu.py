"""FC-DenseNet, plain (Jégou et al., arXiv:1611.09326; reference
lib/models/tiramisu.py:93-205), and its 67-layer form.

A 3x3 first conv; down path of dense blocks (each layer BatchNorm, ReLU,
3x3 conv to ``growth`` channels, Dropout2d(0.2), concatenated to its input)
and transitions down (BatchNorm, ReLU, 1x1 conv, Dropout2d(0.2), 2x2 max
pool); a bottleneck dense block that returns only its new channels; up path
of transitions up (a 3x3 stride-2 transposed conv, centre-cropped to the
skip, concatenated with it) and dense blocks, which return only their new
channels except the last; a 1x1 head. Attribute names are the reference's
state_dict keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.numerics import Norm, Numerics

DROP = 0.2


class DenseLayer(nn.Module):
    def __init__(self, nx: Numerics, cin: int, growth: int):
        super().__init__()
        self.nx = nx
        self.norm = Norm(cin)
        self.conv = nn.Conv2d(cin, growth, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.nx.conv(self.conv, F.relu(self.norm(x)))
        return self.nx.dropout2d(y, DROP, self.training)


class DenseBlock(nn.Module):
    def __init__(self, nx: Numerics, cin: int, growth: int, n: int, upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.layers = nn.ModuleList(DenseLayer(nx, cin + i * growth, growth) for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        new = []
        for layer in self.layers:
            out = layer(x)
            x = torch.cat([x, out], 1)
            new.append(out)
        return torch.cat(new, 1) if self.upsample else x


class TransitionDown(nn.Module):
    def __init__(self, nx: Numerics, c: int):
        super().__init__()
        self.nx = nx
        self.norm = Norm(c)
        self.conv = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.nx.conv(self.conv, F.relu(self.norm(x)))
        return F.max_pool2d(self.nx.dropout2d(y, DROP, self.training), 2, 2)


class TransitionUp(nn.Module):
    def __init__(self, nx: Numerics, cin: int, cout: int):
        super().__init__()
        self.nx = nx
        self.convTrans = nn.ConvTranspose2d(cin, cout, 3, 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.nx.deconv(self.convTrans, x)
        h, w = skip.shape[2:]
        y0, x0 = (up.shape[2] - h) // 2, (up.shape[3] - w) // 2
        return torch.cat([up[:, :, y0:y0 + h, x0:x0 + w], skip], 1)


class Bottleneck(nn.Module):
    def __init__(self, nx: Numerics, cin: int, growth: int, n: int):
        super().__init__()
        self.bottleneck = DenseBlock(nx, cin, growth, n, upsample=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneck(x)


class FCDenseNet(nn.Module):
    def __init__(self, nx: Numerics, down: Sequence[int], up: Sequence[int], bottleneck: int,
                 growth: int, first: int, in_channels: int = 3, n_classes: int = 1):
        super().__init__()
        self.nx = nx
        self.firstconv = nn.Conv2d(in_channels, first, 3, padding=1)
        cur, skips = first, []
        self.denseBlocksDown, self.transDownBlocks = nn.ModuleList(), nn.ModuleList()
        for n in down:
            self.denseBlocksDown.append(DenseBlock(nx, cur, growth, n))
            cur += growth * n
            skips.insert(0, cur)
            self.transDownBlocks.append(TransitionDown(nx, cur))
        self.bottleneck = Bottleneck(nx, cur, growth, bottleneck)
        prev = growth * bottleneck
        self.transUpBlocks, self.denseBlocksUp = nn.ModuleList(), nn.ModuleList()
        for i, n in enumerate(up):
            last = i == len(up) - 1
            self.transUpBlocks.append(TransitionUp(nx, prev, prev))
            cur = prev + skips[i]
            self.denseBlocksUp.append(DenseBlock(nx, cur, growth, n, upsample=not last))
            prev = growth * n
        self.finalConv = nn.Conv2d(cur + prev, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, skips = self.nx.conv(self.firstconv, x), []
        for dense, down in zip(self.denseBlocksDown, self.transDownBlocks):
            out = dense(out)
            skips.append(out)
            out = down(out)
        out = self.bottleneck(out)
        for up, dense in zip(self.transUpBlocks, self.denseBlocksUp):
            out = dense(up(out, skips.pop()))
        return self.nx.conv(self.finalConv, out)


def FCDenseNet67(nx: Numerics, in_channels: int = 3, n_classes: int = 1) -> FCDenseNet:
    """Five blocks of 5 layers each way, a bottleneck of 5, growth 16, 48
    first-conv channels (Jégou et al., table 2)."""
    return FCDenseNet(nx, (5,) * 5, (5,) * 5, 5, 16, 48, in_channels, n_classes)
