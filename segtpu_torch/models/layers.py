"""Layers of the port (counterparts of segtpu/models/layers.py).

NCHW modules whose attribute and buffer names are the reference's
state_dict keys (``weight``, ``bias``, ``running_mean``, ``running_var``), so
a reference ``.pth`` or :func:`segtpu_torch.compat.jax_params.state_dict_from_jax`
loads with ``load_state_dict``. In training mode the normalisations use the
batch statistics (kernels B1, B2, B3 through :mod:`segtpu_torch.ops.abn`) and
update their running statistics as torch's ``BatchNorm2d`` does (``ABN``
is a BatchNorm followed by its activation): momentum
0.1, and the running var takes the unbiased variance ``var * N / (N - 1)``.
Each layer takes its channel sums once: the statistics that normalise the
batch are the ones that update the running buffers. Random init takes an
explicit ``torch.Generator`` (``reset_parameters``).

Under :func:`remat` a block's forward runs again in the backward pass; the
running statistics are updated by the first forward only, as flax's
``nn.remat`` keeps only the first forward's ``batch_stats``.

Data parallel: a normalisation layer whose ``process_group`` is set
(:func:`set_process_group`, segtpu's ``axis_name``) normalises with the
statistics of the global batch over that group, and its running statistics
take the global mean and unbiased variance. The dropouts draw the mask of the
global batch and keep their rank's rows (:func:`set_data_shard`), so N ranks
draw the masks one process draws on the same global batch.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from segtpu_torch.ops import abn as abn_ops
from segtpu_torch.parallel import group_size

# Set while torch.utils.checkpoint recomputes a block (see :func:`remat`), in
# the thread that recomputes it.
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = before


def remat(block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """``block(*args)`` that keeps none of its activations for the backward
    pass and recomputes them there (segtpu's ``nn.remat``), through
    ``torch.utils.checkpoint`` (non-reentrant, RNG state preserved, so a
    dropout draws the same mask again). During the recompute the
    normalisation layers leave their running statistics alone."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def _update_running_stats(module: nn.Module, x: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor) -> None:
    """``running = (1 - momentum) * running + momentum * batch``, with the
    unbiased batch variance in the running var (segtpu layers.py:116-120);
    nothing while :func:`remat` recomputes a block. Under a process group
    the batch is the global one (each rank holds an equal shard)."""
    if getattr(_recompute, "on", False):
        return
    count = x.numel() // x.shape[1] * group_size(module.process_group)
    m = module.momentum
    with torch.no_grad():
        module.running_mean.mul_(1 - m).add_(mean, alpha=m)
        module.running_var.mul_(1 - m).add_(var * (count / max(count - 1, 1)), alpha=m)
        if hasattr(module, "num_batches_tracked"):
            module.num_batches_tracked.add_(1)


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class BatchNormTorch(nn.Module):
    """BatchNorm2d with torch running-stat semantics (segtpu
    ``BatchNormTorch``): batch statistics through :class:`~segtpu_torch.ops.abn.BNTrain`
    in training mode, the running statistics in eval mode."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 process_group=None):
        super().__init__()
        self.features, self.eps, self.momentum = features, eps, momentum
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = abn_ops.bn_train(x, self.weight, self.bias, self.eps,
                                            self.process_group)
            _update_running_stats(self, x, mean, var)
            return y
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class ABN(BatchNormTorch):
    """Plain (not fused) BatchNorm then activation (segtpu ``ABN``;
    reference lib/modules/abn/bn.py:23-44). The parameters and running
    statistics sit on the module itself (``weight``, ``bias``,
    ``running_mean``, ``running_var``), as the reference ABN's. Training
    mode: :class:`BatchNormTorch` (B1, B2; backward B1) then the
    activation. Eval mode: one pass of the B2 kernel with the activation
    fused, on the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 activation: str = abn_ops.ACT_LEAKY_RELU, slope: float = 0.01,
                 process_group=None):
        super().__init__(features, eps, momentum, process_group)
        abn_ops._check_act(activation)
        self.activation, self.slope = activation, slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return abn_ops.act_forward(super().forward(x), self.activation, self.slope)
        return abn_ops.fused_abn(
            x, self.weight, self.bias, mean=self.running_mean, var=self.running_var,
            training=False, eps=self.eps, activation=self.activation, slope=self.slope)


class InPlaceABN(nn.Module):
    """Fused activated BN (segtpu ``InPlaceABN``; reference
    lib/modules/abn/bn.py:47-103). Eval mode: one pass of the B2 kernel on
    CUDA. Training mode: :class:`~segtpu_torch.ops.abn.FusedABNTrain` (B1,
    B2; backward B3 from the saved output, never the input)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 activation: str = abn_ops.ACT_LEAKY_RELU, slope: float = 0.01,
                 process_group=None):
        super().__init__()
        self.features, self.eps, self.momentum = features, eps, momentum
        self.activation, self.slope = activation, slope
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            z, mean, var = abn_ops.fused_abn(
                x, self.weight, self.bias, training=True, eps=self.eps,
                activation=self.activation, slope=self.slope, group=self.process_group)
            _update_running_stats(self, x, mean, var)
            return z
        return abn_ops.fused_abn(
            x, self.weight, self.bias, mean=self.running_mean, var=self.running_var,
            training=False, eps=self.eps, activation=self.activation, slope=self.slope)


_Size = Union[int, Tuple[int, int]]


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with segtpu ``Conv``'s defaults (3x3, no padding) and
    torch's default init, U(+-1/sqrt(fan_in)) for weight and bias, where
    fan_in = in_channels / groups * kh * kw. ``kernel_size`` and ``padding``
    take an int or an (h, w) pair: GCN's (7, 1) kernel with padding (3, 0)
    is segtpu's ``Conv(k, (7, 1), padding=[(3, 3), (0, 0)])``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: _Size = 3,
                 stride: int = 1, padding: _Size = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups, bias=bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """torch ``nn.ConvTranspose2d(k, stride, padding, output_padding)``: the
    full transposed conv cropped by ``padding`` / ``padding - output_padding``,
    the crop segtpu's ``ConvTranspose2dTorch`` applies by hand. Weight layout
    (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, output_padding: int = 0,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, output_padding=output_padding, bias=bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # torch's fan_in for a transposed conv weight (in, out, kh, kw)
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling, stride 2, odd sizes floored (segtpu ``max_pool``;
    ``nn.MaxPool2d(2)``). The gradient goes to the first maximal element of
    each window in row-major order, as segtpu's: torch's CPU and CUDA
    kernels, NCHW and channels_last, keep the first of equal values."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling by ``scale`` (segtpu ``upsample_nearest``;
    ``nn.Upsample(scale_factor=2)``), in ``x``'s dtype. CUDA autocast would
    run it in fp32 (its fp32 list holds ``upsample_nearest2d``), which also
    promotes the concatenation with a bf16 skip to fp32; a copy of values
    loses nothing in bf16, which is where segtpu runs it."""
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear(x: torch.Tensor, out_hw: Sequence[int],
                      align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of ``x`` to ``out_hw`` (segtpu ``upsample_bilinear``):
    align_corners where both output sides are above 1, as the GCN, PSPNet
    and DUC heads use it; else segtpu's ``jax.image.resize(method="linear")``,
    half-pixel centres with an antialiasing triangle filter on a side that
    shrinks: one pass per side, since torch's two-sided antialiased resize
    goes wrong where one side grows and the other shrinks to 1. CUDA
    autocast runs ``upsample_bilinear2d`` in fp32, so a bf16 input gives an
    fp32 output, as segtpu's bf16-times-fp32-weights does."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if align_corners and oh > 1 and ow > 1:
        return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)
    h, w = x.shape[2:]
    y = F.interpolate(x, size=(oh, w), mode="bilinear", align_corners=False, antialias=oh < h)
    return F.interpolate(y, size=(oh, ow), mode="bilinear", align_corners=False,
                         antialias=ow < w)


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r) (segtpu ``pixel_shuffle``): the
    channels read as (C, r, r), torch's own order."""
    return F.pixel_shuffle(x, upscale)


def global_avg_pool_2d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C), the mean over the spatial dims (segtpu
    ``global_avg_pool_2d``; reference abn/misc.py:4-11)."""
    return x.mean(dim=(2, 3))


class GlobalAvgPool2d(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool_2d(x)


def float_logits(out: torch.Tensor) -> torch.Tensor:
    """A model's logits in fp32 whatever autocast gave, or float64 for a
    float64 model (a CPU reference run)."""
    return out.to(torch.promote_types(out.dtype, torch.float32))


def _global_batch_draw(x: torch.Tensor, p: float, shard: Tuple[int, int],
                       feature: bool) -> torch.Tensor:
    """This rank's rows of a Bernoulli(1 - p) draw, in ``x``'s dtype, of the
    global batch: shape ``(N * size, C, 1, 1)`` (feature dropout) or
    ``(N * size,) + x.shape[1:]``, cut to the rows of ``shard = (data rank,
    data size)``, on the generator of ``x``'s device."""
    rank, size = shard
    n = x.shape[0]
    shape = (n * size,) + ((x.shape[1],) + (1,) * (x.dim() - 2) if feature else x.shape[1:])
    noise = torch.empty(shape, dtype=x.dtype, device=x.device)
    noise.bernoulli_(1 - p)
    return noise[rank * n:(rank + 1) * n]


class Dropout2d(nn.Dropout2d):
    """segtpu's channel ``Dropout2d`` with ``groups=1``: one Bernoulli draw per
    (sample, channel), kept values scaled by 1 / (1 - p), identity in eval
    mode or at p = 0. The draw is that of the global batch
    (:func:`set_data_shard`). ``groups > 1`` belongs to s2d execution, which
    is not ported."""

    data_shard: Tuple[int, int] = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        # torch's own feature dropout for one rank, bit for bit: the noise
        # is scaled in x's dtype
        noise = _global_batch_draw(x, self.p, self.data_shard, feature=True)
        return x * noise.div_(1 - self.p)


class Dropout(nn.Dropout):
    """Element dropout (``nn.Dropout``) drawn as :class:`Dropout2d` is: the
    mask of the global batch, this rank's rows. As torch's fused dropout
    does, it scales by 1 / (1 - p) at fp32 and rounds each element once (a
    bf16 scale would shrink every kept value: 1.109375 for 1 / 0.9), and
    keeps a bool mask for the backward."""

    data_shard: Tuple[int, int] = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = _global_batch_draw(x, self.p, self.data_shard, feature=False).bool()
        return torch.where(keep, x * (1.0 / (1 - self.p)), 0.0)


def set_data_shard(model: nn.Module, data_rank: int, data_size: int) -> None:
    """Make every dropout of ``model`` draw the global batch's mask and keep
    the rows of data rank ``data_rank`` of ``data_size``."""
    for m in model.modules():
        if isinstance(m, (Dropout2d, Dropout)):
            m.data_shard = (data_rank, data_size)


def set_process_group(model: nn.Module, group) -> None:
    """Sync BatchNorm: every normalisation layer of ``model`` takes its
    training statistics over ``group`` (None: the local batch)."""
    for m in model.modules():
        if isinstance(m, (BatchNormTorch, InPlaceABN)):
            m.process_group = group


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-draw every conv and linear layer of ``module`` from ``generator``,
    in module order (a linear layer as torch's default, U(+-1/sqrt(in))
    for weight and bias); normalisation layers go back to weight 1, bias 0,
    mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose2dTorch)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            _uniform_(m.weight, bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, bound, generator)
        elif isinstance(m, (BatchNormTorch, InPlaceABN)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
