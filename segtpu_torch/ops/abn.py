"""Eval-mode fused Activated BatchNorm (counterpart of segtpu/ops/abn.py).

Inference folds the running statistics into one per-channel affine,
``scale = gamma * rsqrt(var + eps)`` and ``shift = beta - mean * scale``
(fp32), and applies ``act(x * scale + shift)`` in one pass:
:func:`abn_norm_act` sends a CUDA tensor to the hand-written kernel
(``segtpu_torch/csrc/abn_norm_act.cu``) and a CPU tensor to
:func:`abn_norm_act_plain`, the plain PyTorch version with the same fp32
arithmetic. Training mode (batch statistics and the from-output backward,
kernels B1/B3) belongs to the training slice and raises here.

Layout: NCHW, channel dim 1; a 2-D input is a row-major [M, C] view.
"""

from __future__ import annotations

import torch

from segtpu_torch.ops import kernels

ACT_LEAKY_RELU = "leaky_relu"
ACT_ELU = "elu"
ACT_NONE = "none"


def act_forward(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == ACT_LEAKY_RELU:
        return torch.where(y >= 0, y, y * slope)
    if activation == ACT_ELU:
        return torch.where(y >= 0, y, torch.expm1(y))
    if activation == ACT_NONE:
        return y
    raise ValueError(f"unknown activation {activation!r}")


def abn_norm_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       activation: str, slope: float) -> torch.Tensor:
    """act(x * scale + shift) per channel (dim 1) in fp32, rounded once to
    ``x``'s dtype. The kernel's reference; the CPU path of the port."""
    view = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    y = x.float() * scale.float().view(view) + shift.float().view(view)
    return act_forward(y, activation, slope).to(x.dtype)


def abn_norm_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 activation: str, slope: float) -> torch.Tensor:
    """Dispatch by ``x.device``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cuda":
        return kernels.abn_norm_act_cuda(x, scale, shift, activation, slope)
    if x.device.type == "cpu":
        return abn_norm_act_plain(x, scale, shift, activation, slope)
    raise ValueError(f"abn_norm_act: no implementation for device {x.device}")


def fused_abn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
              mean: torch.Tensor, var: torch.Tensor, training: bool = False,
              eps: float = 1e-5, activation: str = ACT_LEAKY_RELU,
              slope: float = 0.01) -> torch.Tensor:
    """Fused BN + activation with running statistics (segtpu ``fused_abn``
    with ``training=False``)."""
    if training:
        raise NotImplementedError(
            "training-mode fused ABN (batch statistics, from-output backward: "
            "kernels B1/B3) arrives with the training slice of the port")
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    shift = beta.float() - mean.float() * scale
    return abn_norm_act(x, scale, shift, activation, slope)
