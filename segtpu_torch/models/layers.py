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

s2d execution (segtpu's ``S2DConv``, ``DeconvS2D``, ``stat_groups``,
``stat_parts`` and ``Dropout2d(groups)``; :mod:`segtpu_torch.ops.s2d`): the
models keep their dense modules and evaluate them in s2d form on request,
so a model's ``state_dict`` is the same in both forms. :func:`s2d_conv` and
:func:`deconv_s2d` apply a conv's or a transposed conv's dense weight
through the expanded kernel; the normalisation layers take ``parts`` (their
own ``stat_groups`` / ``stat_parts`` by default) and combine their
statistics over the sub-positions; ``Dropout2d`` takes ``groups`` and draws
one mask per true channel, the draw that ``groups=1`` makes.

s2d under tensor parallelism (``--s2d --model-parallel N``): an expanded
kernel and grouped statistics mix the channels that a shard splits, so a
sharded module evaluated in s2d form uses its whole weights (:func:`whole`,
an all-gather over the model group whose backward keeps the rank's part of
the gradient) and computes its output on every rank of the group; a
normalisation layer updates its shard of the running statistics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from segtpu_torch.ops import abn as abn_ops
from segtpu_torch.ops import s2d as s2d_ops
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


def remat(block, *args: torch.Tensor, **kwargs) -> torch.Tensor:
    """``block(*args, **kwargs)`` that keeps none of its activations for the
    backward pass and recomputes them there (segtpu's ``nn.remat``), through
    ``torch.utils.checkpoint`` (non-reentrant, RNG state preserved, so a
    dropout draws the same mask again). During the recompute the
    normalisation layers leave their running statistics alone."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()), **kwargs)


@dataclasses.dataclass(frozen=True)
class Shards:
    """How tensor parallelism cut a module (``module.tp_shards``, set by
    :func:`segtpu_torch.parallel.tensor.shard_model`): the dim of each
    sharded tensor by attribute name, the model group and this rank's
    place in it."""

    dims: Dict[str, int]
    group: object
    rank: int
    size: int


class _GatherShard(torch.autograd.Function):
    """A shard made whole over the model group (all-gather along ``dim``);
    the backward keeps this rank's part of the gradient."""

    @staticmethod
    def forward(ctx, t, dim: int, shards: Shards):
        ctx.dim, ctx.rank, ctx.width = dim, shards.rank, t.shape[dim]
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(shards.size)]
        dist.all_gather(parts, t.contiguous(), group=shards.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


def whole(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module.<name>``, gathered over the model group where tensor
    parallelism sharded it, else the tensor itself (module docstring)."""
    t = getattr(module, name)
    shards = getattr(module, "tp_shards", None)
    if t is None or shards is None or name not in shards.dims:
        return t
    return _GatherShard.apply(t, shards.dims[name], shards)


def _update_running_stats(module: nn.Module, x: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor) -> None:
    """``running = (1 - momentum) * running + momentum * batch``, with the
    unbiased batch variance in the running var (segtpu layers.py:116-120);
    nothing while :func:`remat` recomputes a block. Under a process group
    the batch is the global one (each rank holds an equal shard). The count
    is per true channel: ``4 n`` for an s2d input."""
    if getattr(_recompute, "on", False):
        return
    count = x.numel() // mean.numel() * group_size(module.process_group)
    if mean.numel() != module.running_mean.numel():
        # a sharded layer's whole statistics (s2d form): this rank's part
        shards = module.tp_shards
        width = module.running_mean.numel()
        mean, var = (v.narrow(0, shards.rank * width, width) for v in (mean, var))
    m = module.momentum
    with torch.no_grad():
        module.running_mean.mul_(1 - m).add_(mean, alpha=m)
        module.running_var.mul_(1 - m).add_(var * (count / max(count - 1, 1)), alpha=m)
        if hasattr(module, "num_batches_tracked"):
            module.num_batches_tracked.add_(1)


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _stat_parts(features: int, stat_groups: int, stat_parts):
    if stat_parts is not None:
        parts = tuple(int(p) for p in stat_parts)
        if sum(parts) != features:
            raise ValueError(f"stat_parts {parts} do not sum to {features} features")
        return parts
    if stat_groups not in (1, 4):
        raise ValueError(f"stat_groups is 1 or 4 (s2d), got {stat_groups}")
    return (features,) if stat_groups == 4 else None


def _check_parts(module: nn.Module, x: torch.Tensor, parts) -> None:
    # the layer's own channels: a tensor-parallel shard holds 1/N of them,
    # except in s2d form, where the layer is whole (module docstring)
    want = module.weight.shape[0] if parts is None else 4 * module.features
    if x.shape[1] != want:
        raise ValueError(f"{type(module).__name__}({module.features}) with parts {parts} takes "
                         f"{want} channels, got {x.shape[1]}")


def _norm_tensors(module: nn.Module, parts, *names: str):
    """A normalisation layer's tensors: whole in s2d form (``parts``; module
    docstring), its own otherwise."""
    return tuple(getattr(module, n) if parts is None else whole(module, n) for n in names)


class BatchNormTorch(nn.Module):
    """BatchNorm2d with torch running-stat semantics (segtpu
    ``BatchNormTorch``): batch statistics through :class:`~segtpu_torch.ops.abn.BNTrain`
    in training mode, the running statistics in eval mode.

    ``stat_groups=4``: the input is the s2d form of ``features`` channels;
    ``stat_parts``: a block-wise concat of s2d tensors of these true channel
    counts (their sum is ``features``). ``forward(x, parts)`` overrides
    both for one call, ``parts=(features,)`` being ``stat_groups=4``.
    Statistics combine over the sub-positions; the parameters and running
    statistics keep their ``[features]`` shapes."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 process_group=None, stat_groups: int = 1, stat_parts=None):
        super().__init__()
        self.features, self.eps, self.momentum = features, eps, momentum
        self.stat_parts = _stat_parts(features, stat_groups, stat_parts)
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, parts=None) -> torch.Tensor:
        parts = self.stat_parts if parts is None else tuple(parts)
        _check_parts(self, x, parts)
        weight, bias = _norm_tensors(self, parts, "weight", "bias")
        if self.training:
            y, mean, var = abn_ops.bn_train(x, weight, bias, self.eps, self.process_group, parts)
            _update_running_stats(self, x, mean, var)
            return y
        mean, var = _norm_tensors(self, parts, "running_mean", "running_var")
        e = lambda v: abn_ops._expand_parts(v, parts)  # noqa: E731
        return F.batch_norm(x, e(mean), e(var), e(weight), e(bias), False, 0.0, self.eps)


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
                 process_group=None, stat_groups: int = 1):
        super().__init__(features, eps, momentum, process_group, stat_groups)
        abn_ops._check_act(activation)
        self.activation, self.slope = activation, slope

    def forward(self, x: torch.Tensor, parts=None) -> torch.Tensor:
        if self.training:
            return abn_ops.act_forward(super().forward(x, parts), self.activation, self.slope)
        parts = self.stat_parts if parts is None else tuple(parts)
        _check_parts(self, x, parts)
        weight, bias, mean, var = _norm_tensors(self, parts, "weight", "bias", "running_mean",
                                                "running_var")
        return abn_ops.fused_abn(x, weight, bias, mean=mean, var=var, training=False,
                                 eps=self.eps, activation=self.activation, slope=self.slope,
                                 parts=parts)


class InPlaceABN(nn.Module):
    """Fused activated BN (segtpu ``InPlaceABN``; reference
    lib/modules/abn/bn.py:47-103). Eval mode: one pass of the B2 kernel on
    CUDA. Training mode: :class:`~segtpu_torch.ops.abn.FusedABNTrain` (B1,
    B2; backward B3 from the saved output, never the input). ``stat_groups``
    and ``forward(x, parts)``: s2d input, as :class:`BatchNormTorch`'s."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 activation: str = abn_ops.ACT_LEAKY_RELU, slope: float = 0.01,
                 process_group=None, stat_groups: int = 1):
        super().__init__()
        self.features, self.eps, self.momentum = features, eps, momentum
        self.activation, self.slope = activation, slope
        self.stat_parts = _stat_parts(features, stat_groups, None)
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, parts=None) -> torch.Tensor:
        parts = self.stat_parts if parts is None else tuple(parts)
        _check_parts(self, x, parts)
        weight, bias = _norm_tensors(self, parts, "weight", "bias")
        if self.training:
            z, mean, var = abn_ops.fused_abn(
                x, weight, bias, training=True, eps=self.eps, activation=self.activation,
                slope=self.slope, group=self.process_group, parts=parts)
            _update_running_stats(self, x, mean, var)
            return z
        mean, var = _norm_tensors(self, parts, "running_mean", "running_var")
        return abn_ops.fused_abn(x, weight, bias, mean=mean, var=var, training=False,
                                 eps=self.eps, activation=self.activation, slope=self.slope,
                                 parts=parts)


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


def s2d_conv(conv: nn.Conv2d, x: torch.Tensor, in_perm=None, in_parts=None) -> torch.Tensor:
    """``conv`` (stride 1, odd square kernel, no groups) as a SAME conv of
    the s2d tensor ``x``, giving the s2d form of its output (segtpu
    ``S2DConv``): the dense weight expanded by
    :func:`~segtpu_torch.ops.s2d.s2d_kernel`, or by
    :func:`~segtpu_torch.ops.s2d.expand_kernel_parts` for ``in_parts``; its
    input channels reordered by ``in_perm`` for a block-wise concat input.
    The conv's own padding does not apply: a 3x3 conv with padding 0 is run
    as SAME (LinkNet34's head crops the rows that differ)."""
    weight, bias = whole(conv, "weight"), whole(conv, "bias")
    if in_parts is not None:
        kp = s2d_ops.expand_kernel_parts(weight, in_parts)
    else:
        kp = s2d_ops.s2d_kernel(weight)
    if in_perm is not None:
        kp = kp[:, torch.as_tensor(in_perm, device=kp.device)]
    bias = None if bias is None else bias.repeat(4)
    return F.conv2d(x, kp, bias, padding=kp.shape[2] // 2)


def deconv_s2d(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``deconv`` (kernel 4, stride 2, padding 1) applied so that its output
    comes out in s2d form at the input's resolution (segtpu ``DeconvS2D``):
    one stride-1 3x3 conv with the weight of
    :func:`~segtpu_torch.ops.s2d.deconv_s2d_kernel`."""
    weight, bias = whole(deconv, "weight"), whole(deconv, "bias")
    bias = None if bias is None else bias.repeat(4)
    return F.conv2d(x, s2d_ops.deconv_s2d_kernel(weight), bias, padding=1)


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
                       feature: bool, groups: int = 1) -> torch.Tensor:
    """This rank's rows of a Bernoulli(1 - p) draw, in ``x``'s dtype, of the
    global batch: shape ``(N * size, C // groups, 1, 1)`` (feature dropout)
    or ``(N * size,) + x.shape[1:]``, cut to the rows of ``shard = (data
    rank, data size)``, on the generator of ``x``'s device."""
    rank, size = shard
    n = x.shape[0]
    shape = (n * size,) + ((x.shape[1] // groups,) + (1,) * (x.dim() - 2) if feature
                           else x.shape[1:])
    noise = torch.empty(shape, dtype=x.dtype, device=x.device)
    noise.bernoulli_(1 - p)
    return noise[rank * n:(rank + 1) * n]


class Dropout2d(nn.Dropout2d):
    """segtpu's channel ``Dropout2d``: one Bernoulli draw per (sample,
    channel), kept values scaled by 1 / (1 - p), identity in eval mode or at
    p = 0. The draw is that of the global batch (:func:`set_data_shard`).
    ``forward(x, groups=4)`` (an s2d input, sub-position-major): one draw per
    true channel, the same draw that ``groups=1`` makes from the same
    generator state, repeated over the 4 sub-positions, so the s2d and the
    normal-space forms of a model drop the same channels."""

    data_shard: Tuple[int, int] = (0, 1)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        # torch's own feature dropout for one rank, bit for bit: the noise
        # is scaled in x's dtype
        noise = _global_batch_draw(x, self.p, self.data_shard, feature=True, groups=groups)
        noise = noise.div_(1 - self.p)
        return x * (noise if groups == 1 else noise.repeat(1, groups, 1, 1))


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
