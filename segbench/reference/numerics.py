"""How a reference computes: its convolutions' precision and its dropout.

* ``fp32``: plain fp32 convolutions; :func:`exact` turns TF32 off around
  a reference run, as a float32 matmul on an H100 may otherwise run in TF32.
* ``fp8``: the control, the step below the bf16 that the configurations
  state, as fp8 training runs it: the forward runs under bf16 autocast as
  the program's does; every convolution's input and weight are first
  rounded to ``float8_e4m3fn`` and the gradient that reaches its output to
  ``float8_e5m2``, each scaled per tensor by its absolute maximum over the
  format's largest value, so that the forward, the data gradient and the
  weight gradient all take fp8 operands.

Dropout follows the port's rule (segtpu_torch ``train.state``, frozen
here): a step's masks come from the default generator of the batch's device
seeded with :func:`dropout_seed` ``(run seed, step)``, one Bernoulli draw of
shape ``(N, C, 1, 1)`` per ``Dropout2d`` in module order, in the dtype the
activations have in the program (bf16 under autocast), scaled by ``1 / (1 -
p)`` in that dtype.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the formats' largest finite values
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def dropout_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout stream: a hash of (seed, 11, step)."""
    state = np.random.SeedSequence([seed, 11, step]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator


@contextlib.contextmanager
def exact():
    """TF32 off for the block, the previous settings back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = t.abs().amax().float().clamp_min(1e-30) / FP8_MAX[dtype]
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 with a per-tensor scale; identity gradient."""
    return t + (_round(t.detach(), torch.float8_e4m3fn) - t).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Numerics:
    """``precision`` ``"fp32"`` or ``"fp8"``; ``mask_dtype``: the dtype of the
    dropout draws (module docstring)."""

    def __init__(self, precision: str = "fp32", mask_dtype: torch.dtype = torch.float32):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision, self.mask_dtype = precision, mask_dtype

    def forward(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``model(x)`` in this precision, as fp32 logits (float64 for a
        float64 model)."""
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.precision == "fp8"):
            out = model(x)
        return out.to(torch.promote_types(out.dtype, torch.float32))

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.precision == "fp32" else fp8(t)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32" or not torch.is_grad_enabled():
            return y
        return _GradFp8.apply(y)

    def conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return self._out(F.conv2d(self._q(x), self._q(m.weight), m.bias, m.stride, m.padding,
                                  m.dilation, m.groups))

    def deconv(self, m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        return self._out(F.conv_transpose2d(self._q(x), self._q(m.weight), m.bias, m.stride,
                                            m.padding, m.output_padding, m.groups, m.dilation))

    def dropout2d(self, x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
        if not training or p == 0.0:
            return x
        noise = torch.empty((x.shape[0], x.shape[1], 1, 1), dtype=self.mask_dtype,
                            device=x.device)
        noise.bernoulli_(1 - p)
        noise.div_(1 - p)
        return x * noise.to(x.dtype)


class Norm(nn.Module):
    """BatchNorm over dim 1 (batch statistics in training, running ones in
    eval; momentum 0.1, eps 1e-5), then LeakyReLU(``slope``) when given: an
    InPlaceABN. ``count``: the ``num_batches_tracked`` buffer of a
    BatchNorm2d's state_dict (an InPlaceABN has none)."""

    def __init__(self, features: int, count: bool = True, slope: Optional[float] = None):
        super().__init__()
        self.slope = slope
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        if count:
            self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                         self.training, 0.1, 1e-5)
        return y if self.slope is None else F.leaky_relu(y, self.slope)


def build(cls, device: torch.device, state: dict, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` made without an init on ``device``, its
    every entry taken from ``state`` (strict)."""
    with torch.device("meta"):
        model = cls(*args, **kwargs)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model
