"""Building blocks of the reference's ABN module (counterpart of
segtpu/models/blocks.py; reference lib/modules/abn/misc.py, residual.py,
dense.py): the identity-mapping residual block and the bottlenecked dense
block of WiderResNet-style networks. No registry model uses them.

Submodules carry segtpu's names (``bn1``, ``proj_conv``, ``conv1``, ...),
so :func:`segtpu_torch.compat.jax_params.identity_residual_entries` and
:func:`~segtpu_torch.compat.jax_params.dense_module_entries` map segtpu's
trees onto them. Each normalisation is an :class:`ABN` (BatchNorm then
leaky ReLU): B1 and B2 in training, B2 in eval.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from segtpu_torch.models.layers import ABN, Conv, Dropout, GlobalAvgPool2d, global_avg_pool_2d

__all__ = ["IdentityResidualBlock", "DenseModule", "GlobalAvgPool2d", "global_avg_pool_2d"]


class IdentityResidualBlock(nn.Module):
    """Pre-activation residual block (reference abn/residual.py:8-88).

    ``channels`` of length 2: two 3x3 convs; of length 3: a 1x1 / 3x3 (with
    ``groups``) / 1x1 bottleneck. ``bn1`` feeds the conv path and, when the
    stride or the width changes, the 1x1 projection ``proj_conv`` of the
    shortcut; else the shortcut is the input itself. ``dropout``: the
    probability of an elementwise dropout before the last conv."""

    def __init__(self, in_channels: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, groups: int = 1, dropout: Optional[float] = None):
        super().__init__()
        if len(channels) not in (2, 3):
            raise ValueError("channels must contain either two or three values")
        if len(channels) == 2 and groups != 1:
            raise ValueError("groups > 1 are only valid if len(channels) == 3")
        self.bottleneck = len(channels) == 3
        self.bn1 = ABN(in_channels)
        self.proj_conv = None
        if stride != 1 or in_channels != channels[-1]:
            self.proj_conv = Conv(in_channels, channels[-1], 1, stride=stride, bias=False)
        if not self.bottleneck:
            self.conv1 = Conv(in_channels, channels[0], 3, stride=stride, padding=dilation,
                              dilation=dilation, bias=False)
            self.bn2 = ABN(channels[0])
            self.conv2 = Conv(channels[0], channels[1], 3, padding=dilation, dilation=dilation,
                              bias=False)
        else:
            self.conv1 = Conv(in_channels, channels[0], 1, stride=stride, bias=False)
            self.bn2 = ABN(channels[0])
            self.conv2 = Conv(channels[0], channels[1], 3, padding=dilation, dilation=dilation,
                              groups=groups, bias=False)
            self.bn3 = ABN(channels[1])
            self.conv3 = Conv(channels[1], channels[2], 1, bias=False)
        self.dropout = None if dropout is None else Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn1 = self.bn1(x)
        shortcut = x if self.proj_conv is None else self.proj_conv(bn1)
        y = self.bn2(self.conv1(bn1))
        if self.bottleneck:
            y = self.bn3(self.conv2(y))
        if self.dropout is not None:
            y = self.dropout(y)
        y = self.conv3(y) if self.bottleneck else self.conv2(y)
        return y + shortcut


class DenseModule(nn.Module):
    """Bottlenecked dense block (reference abn/dense.py:9-42): layer ``i``
    takes the concatenation of the input and every earlier layer's output
    through ``bn1_i`` -> 1x1 conv ``conv1_i`` (growth x bottleneck_factor)
    -> ``bn3_i`` -> 3x3 conv ``conv3_i`` (growth); the result is the
    concatenation of all of them."""

    def __init__(self, in_channels: int, growth: int, layers: int, bottleneck_factor: int = 4,
                 dilation: int = 1):
        super().__init__()
        self.layers = layers
        width = in_channels
        for i in range(layers):
            self.add_module(f"bn1_{i}", ABN(width))
            self.add_module(f"conv1_{i}", Conv(width, growth * bottleneck_factor, 1, bias=False))
            self.add_module(f"bn3_{i}", ABN(growth * bottleneck_factor))
            self.add_module(f"conv3_{i}", Conv(growth * bottleneck_factor, growth, 3,
                                               padding=dilation, dilation=dilation, bias=False))
            width += growth
        self.out_channels = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = [x]
        for i in range(self.layers):
            y = torch.cat(inputs, dim=1)
            y = getattr(self, f"conv1_{i}")(getattr(self, f"bn1_{i}")(y))
            y = getattr(self, f"conv3_{i}")(getattr(self, f"bn3_{i}")(y))
            inputs.append(y)
        return torch.cat(inputs, dim=1)
