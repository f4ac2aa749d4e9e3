"""Wide ResNet classifier (counterpart of segtpu/models/wider_resnet.py;
reference lib/models/wider_resnet.py:25-84).

The reference's version cannot run (its forward names an undefined
``self.bn1`` and ``self.linear``, wider_resnet.py:79-82) and the harness
never imports it; segtpu rebuilt it with the intended head, BatchNorm ->
ReLU -> global average pool -> linear, and so does the port. It is a
classifier and stays out of the segmentation registry, as in segtpu:
``get_model("wider_resnet")`` raises ``ValueError``.

Module names follow torch's: ``conv1``; ``layer1``..``layer3``, each an
``nn.Sequential`` of :class:`WideBasic` blocks (``bn1``, ``conv1``,
``bn2``, ``conv2``, ``shortcut``); ``bn1``; ``linear``.
:func:`segtpu_torch.compat.jax_params.wider_resnet_entries` maps segtpu's
tree (``layer{i}_{b}``) onto them. Each BatchNorm runs B1 and B2 in
training mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import BatchNormTorch, Conv, Dropout, global_avg_pool_2d


class WideBasic(nn.Module):
    """Pre-activation wide basic block (reference wider_resnet.py:25-46):
    BN -> ReLU -> 3x3 conv -> dropout -> BN -> ReLU -> 3x3 conv (``stride``),
    plus the input, through a 1x1 conv ``shortcut`` where the stride or the
    width changes."""

    def __init__(self, in_planes: int, planes: int, dropout_rate: float = 0.0, stride: int = 1):
        super().__init__()
        self.bn1 = BatchNormTorch(in_planes)
        self.conv1 = Conv(in_planes, planes, 3, padding=1)
        self.dropout = Dropout(dropout_rate)
        self.bn2 = BatchNormTorch(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1)
        self.shortcut = None
        if stride != 1 or in_planes != planes:
            self.shortcut = Conv(in_planes, planes, 1, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(self.dropout(y))))
        return y + (x if self.shortcut is None else self.shortcut(x))


class WideResNet(nn.Module):
    """WRN-``depth``-``widen_factor``: depth = 6n + 4, three stages of n
    blocks at widths 16k, 32k, 64k (reference wider_resnet.py:48-76).
    ``x``: NCHW images; returns ``[N, num_classes]`` logits."""

    def __init__(self, depth: int = 28, widen_factor: int = 10, dropout_rate: float = 0.0,
                 num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError("Wide-resnet depth should be 6n+4")
        n = (depth - 4) // 6
        stages = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.conv1 = Conv(in_channels, stages[0], 3, padding=1)
        width = stages[0]
        for li, (planes, stride) in enumerate(zip(stages[1:], (1, 2, 2))):
            blocks = []
            for b in range(n):
                blocks.append(WideBasic(width, planes, dropout_rate, stride if b == 0 else 1))
                width = planes
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.bn1 = BatchNormTorch(stages[3])
        self.linear = nn.Linear(stages[3], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer3(self.layer2(self.layer1(self.conv1(x))))
        y = global_avg_pool_2d(F.relu(self.bn1(y)))
        return self.linear(y)
