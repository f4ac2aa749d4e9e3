"""Frozen head + afterburner stack (counterpart of
segtpu/models/afterburner_stack.py; reference torch_train_ab.py:241-250):
the head's logits pass through a sigmoid into a 1-channel UNet refiner.

Freezing follows the reference: only the afterburner's parameters train
(:func:`head_frozen_mask`, the train step zeroes the head's gradients), but
the head's running statistics keep updating in training mode (the reference
never calls ``head.eval()``).
"""

from __future__ import annotations

from typing import Set

import torch
from torch import nn

from segtpu_torch.models.unet import Afterburner


class AfterburnerStack(nn.Module):
    """``afterburner(sigmoid(head(x)))``; parameter names ``head.*`` and
    ``afterburner.unet.*``."""

    def __init__(self, head: nn.Module):
        super().__init__()
        self.head = head
        self.afterburner = Afterburner()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.afterburner(torch.sigmoid(self.head(x)))


def head_frozen_mask(model: AfterburnerStack) -> Set[str]:
    """The names of the parameters that train: every one outside ``head.``
    (torch_train_ab.py:245-250)."""
    return {n for n, _ in model.named_parameters() if not n.startswith("head.")}
