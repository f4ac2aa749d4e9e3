"""Optimizers with torch's default hyperparameters (reference
torch_train.py:67-79) and the learning-rate schedules (counterpart of
segtpu/train/optim.py).

The learning rate is a run-time value: :func:`set_learning_rate` writes it
into every parameter group before a step, as segtpu's
``optax.inject_hyperparams`` makes it an input of the compiled step. It is a
host float, so setting it costs no device work.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def get_optimizer(optimizer_name: str, params: Iterable[torch.nn.Parameter],
                  learning_rate: float) -> torch.optim.Optimizer:
    """name -> optimizer: sgd (no momentum), rms (RMSprop, alpha 0.99, eps 1e-8
    outside the sqrt), adam (betas 0.9/0.999, eps 1e-8)."""
    name = optimizer_name.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "rms":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99, eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(optimizer_name)


def set_learning_rate(optimizer: torch.optim.Optimizer, learning_rate: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = learning_rate


def step_learning_rate(epoch: int, initial_lr: float) -> float:
    """Initial LR decayed by 10 every 10 epochs (reference torch_train.py:151-156)."""
    return initial_lr * (0.1 ** (epoch // 10))


def cosine_annealing_lr(epoch: int, base_lr: float, t_max: int = 10,
                        eta_min: float = 1e-8) -> float:
    """torch CosineAnnealingLR(T_max=10, eta_min=1e-8) in closed form
    (reference torch_train.py:402-404)."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


def lr_finder_schedule(n_steps: int = 30, min_lr: float = 1e-8):
    """Exponential sweep 1e-8 * 2^i (reference lib/train_utils.py:38-49)."""
    return [min_lr * (2.0 ** i) for i in range(n_steps)]
