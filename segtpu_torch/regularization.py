"""Convolution weight regularisation (counterpart of segtpu/regularization.py;
reference torch_train_reg.py:40-62).

L1 on the kernels (sparsity) plus L2 on the biases, summed over the regular
convolutions: every ``nn.Conv2d``, which excludes the transposed ones
(``nn.ConvTranspose2d`` is not a subclass). That is the reference's
``isinstance(m, nn.Conv2d)`` and the same set of layers as segtpu's walk
over its ``Conv_0`` subtrees. The train step adds the penalty to the scaled
loss: ``batch_size * loss + l1 + l2`` (torch_train_reg.py:97).
"""

from __future__ import annotations

import torch
from torch import nn


def conv2d_regularization(model: nn.Module, l1_factor: float = 0.0005,
                          l2_factor: float = 0.0005) -> torch.Tensor:
    """``l1_factor * sum |kernel| + l2_factor * sum bias^2`` over the model's
    convolutions, a 0-d tensor on the model's device."""
    l1, l2 = [], []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            l1.append(m.weight.abs().sum())
            if m.bias is not None:
                l2.append(m.bias.square().sum())
    zero = next(model.parameters()).new_zeros(())
    return l1_factor * sum(l1, zero) + l2_factor * sum(l2, zero)


def make_conv2d_penalty(l1_factor: float = 0.0005, l2_factor: float = 0.0005):
    """The penalty for ``make_train_step(param_penalty=...)``."""
    def penalty(model: nn.Module) -> torch.Tensor:
        return conv2d_regularization(model, l1_factor, l2_factor)
    return penalty
