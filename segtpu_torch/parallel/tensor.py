"""Tensor parallelism: channel-sharded layers over the model axis
(counterpart of segtpu/parallel/tensor.py).

segtpu shards each conv kernel on its output channels, and each per-channel
vector, over its ``model`` mesh axis when the channel count is divisible by
the axis size and at least ``MIN_FEATURES`` (segtpu/parallel/tensor.py:28-44);
everything else stays replicated. Here the ``model_size`` ranks of one model
group hold the same data and compute the same activations, and:

  * a conv (``groups == 1``) with ``out_channels`` divisible by N and >= 64
    keeps 1/N of its output channels (weight and bias) and computes only
    those; its output is gathered along the channels, with autograd, before
    the next layer reads it;
  * a transposed conv keeps, as segtpu does with its HWOI kernels, 1/N of
    its input channels when they are eligible: it reads its channels of the
    input and the ranks' partial outputs are summed; its bias is sharded on
    its own size and gathered;
  * a normalisation layer (``BatchNormTorch``, ``ABN``, ``InPlaceABN``) with
    as many features keeps 1/N of its weight, bias and running statistics,
    normalises its channels of the (replicated) input, and gathers its
    output the same way; B1/B2/B3 then run on the rank's channels;
  * every other layer stays replicated (grouped convs and linear layers too,
    whose kernels and biases segtpu also shards; LinkNet34, the model of the
    parallel paths, has neither);
  * a sharded module that a model evaluates in s2d form (``--s2d``) uses
    its whole tensors there, gathered with autograd, and computes on every
    rank of the group (``segtpu_torch.models.layers.whole``); its hooks
    leave an s2d call alone.

The autograd rules make each rank's gradients those of the one-process
step: the gather's backward keeps the rank's channels of the incoming
gradient, a sharded conv's input sums its partial input gradients over the
model group, and a sharded normalisation's input gathers them. Adam's and
RMSprop's moments follow their parameters: built on the shards, they hold
1/N per rank.

A checkpoint holds the gathered, full ``state_dict`` and optimizer state
(:func:`full_state_dict`, :func:`full_optimizer_state`), which load in a
one-process run. ``-r`` loads the full weights into the whole model, shards
it with :func:`shard_model`, and cuts the optimizer state to the shards with
:func:`shard_optimizer_state`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import BatchNormTorch, InPlaceABN, Shards
from segtpu_torch.parallel import Grid

MIN_FEATURES = 64


def _dense_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    fmt = (torch.channels_last if like.dim() == 4 and not like.is_contiguous()
           and like.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    return t.contiguous(memory_format=fmt)


def _all_gather_channels(t: torch.Tensor, group) -> torch.Tensor:
    return _dense_like(gather_shard(t, 1, group), t)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the model
    group (each rank's sharded layer contributes its channels' part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumFromModel(torch.autograd.Function):
    """Sum of the model group's partial outputs; every rank's gradient is the
    whole one, which passes through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous()
        dist.all_reduce(out, group=group)
        return _dense_like(out, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the channels (dim 1, or dim 0 of a vector); the
    backward keeps this rank's channels."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.dim = rank, min(1, x.dim() - 1)
        ctx.width = x.shape[ctx.dim]
        if ctx.dim == 0:
            return gather_shard(x, 0, group)
        return _all_gather_channels(x, group)

    @staticmethod
    def backward(ctx, g):
        return _dense_like(g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), g), None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's channels of a replicated input; the backward gathers the
    ranks' channel gradients."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        width = x.shape[1] // size
        ctx.group = group
        return _dense_like(x[:, rank * width:(rank + 1) * width], x)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_channels(g, ctx.group), None, None, None


def _eligible(n: int, tp: int) -> bool:
    return n % tp == 0 and n >= MIN_FEATURES


def _cut(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    width = t.shape[dim] // size
    return t.narrow(dim, rank * width, width).clone()


def _shard_tensors(module: nn.Module, prefix: str, names: Dict[str, int], grid: Grid,
                   sharded: Dict[str, int]) -> None:
    dims = {attr: dim for attr, dim in names.items() if getattr(module, attr) is not None}
    module.tp_shards = Shards(dims, grid.model_group, grid.model_rank, grid.model_size)
    for attr, dim in dims.items():
        t = getattr(module, attr)
        local = _cut(t.data, dim, grid.model_rank, grid.model_size)
        if isinstance(t, nn.Parameter):
            setattr(module, attr, nn.Parameter(local, requires_grad=t.requires_grad))
        else:
            setattr(module, attr, local)
        sharded[prefix + attr] = dim


def shard_model(model: nn.Module, grid: Grid) -> Dict[str, int]:
    """Shard ``model`` in place over ``grid``'s model group; returns the
    sharded ``state_dict`` keys and the dim each is cut along. Every rank of
    the group must hold the same full weights before (``replicate``).
    Build the optimizer after this call, on the shards."""
    sharded: Dict[str, int] = {}
    tp, group = grid.model_size, grid.model_group
    if tp == 1:
        return sharded

    def copy_in(module, args):
        return (_CopyToModel.apply(args[0], group),) + tuple(args[1:])

    def scatter_in(module, args, kwargs):
        if _s2d_call(module, args, kwargs):
            return None
        x = _ScatterToModel.apply(args[0], group, grid.model_rank, tp)
        return (x,) + tuple(args[1:]), kwargs

    def gather_out(module, args, out):
        return _GatherFromModel.apply(out, group, grid.model_rank)

    def gather_norm_out(module, args, kwargs, out):
        return None if _s2d_call(module, args, kwargs) else gather_out(module, args, out)

    for name, m in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(m, nn.Conv2d) and m.groups == 1 and _eligible(m.out_channels, tp):
            _shard_tensors(m, prefix, {"weight": 0, "bias": 0}, grid, sharded)
            m.register_forward_pre_hook(copy_in)
            m.register_forward_hook(gather_out)
        elif isinstance(m, nn.ConvTranspose2d) and m.groups == 1:
            cut_in = _eligible(m.in_channels, tp)
            cut_bias = m.bias is not None and _eligible(m.out_channels, tp)
            if cut_in or cut_bias:
                _shard_tensors(m, prefix, dict(([("weight", 0)] if cut_in else [])
                                               + ([("bias", 0)] if cut_bias else [])),
                               grid, sharded)
                m.forward = _sharded_deconv_forward(m, grid, cut_in, cut_bias)
        elif isinstance(m, (BatchNormTorch, InPlaceABN)) and _eligible(m.features, tp):
            _shard_tensors(m, prefix, {"weight": 0, "bias": 0, "running_mean": 0,
                                       "running_var": 0}, grid, sharded)
            m.register_forward_pre_hook(scatter_in, with_kwargs=True)
            m.register_forward_hook(gather_norm_out, with_kwargs=True)
    return sharded


def _s2d_call(module: nn.Module, args, kwargs) -> bool:
    """A normalisation layer called on an s2d input: it then works on whole
    tensors (``layers.whole``) and its hooks leave input and output alone."""
    parts = args[1] if len(args) > 1 else kwargs.get("parts")
    return parts is not None or module.stat_parts is not None


def _sharded_deconv_forward(m: nn.ConvTranspose2d, grid: Grid, cut_in: bool, cut_bias: bool):
    """``m.forward`` over its shards: this rank's input channels through its
    rows of the kernel, the partial outputs summed over the model group, then
    the (gathered) bias."""
    group, rank, tp = grid.model_group, grid.model_rank, grid.model_size

    def forward(x: torch.Tensor, output_size=None) -> torch.Tensor:
        if output_size is not None:
            raise ValueError("a sharded transposed conv takes no output_size")
        if cut_in:
            x = _ScatterToModel.apply(x, group, rank, tp)
        out = F.conv_transpose2d(x, m.weight, None, m.stride, m.padding, m.output_padding,
                                 m.groups, m.dilation)
        if cut_in:
            out = _SumFromModel.apply(out, group)
        if m.bias is not None:
            bias = _GatherFromModel.apply(m.bias, group, rank) if cut_bias else m.bias
            out = out + bias.view(1, -1, 1, 1)
        return out

    return forward


def gather_shard(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor of the model group's shards ``t``, cut along ``dim``
    (collective)."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def full_state_dict(model: nn.Module, sharded: Dict[str, int], grid: Grid) -> Dict[str, torch.Tensor]:
    """The one-process ``state_dict``: sharded entries gathered over the
    model group (collective: every rank of the group calls it)."""
    sd = model.state_dict()
    return {k: gather_shard(v, sharded[k], grid.model_group) if k in sharded else v
            for k, v in sd.items()}


def _param_dims(model: nn.Module, sharded: Dict[str, int]) -> List[Optional[int]]:
    """The shard dim of each parameter in ``model.parameters()`` order (the
    optimizer's state index), None where it is replicated."""
    return [sharded.get(n) for n, _ in model.named_parameters()]


def _map_moments(state: Dict[str, Any], dims: List[Optional[int]], fn) -> Dict[str, Any]:
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, entry in state["state"].items():
        d = dims[idx]
        out["state"][idx] = {k: fn(v, d) if d is not None and isinstance(v, torch.Tensor)
                             and v.dim() > 0 else v for k, v in entry.items()}
    return out


def full_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                         sharded: Dict[str, int], grid: Grid) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with each sharded parameter's moments
    gathered to its full shape (collective over the model group)."""
    return _map_moments(optimizer.state_dict(), _param_dims(model, sharded),
                        lambda v, d: gather_shard(v, d, grid.model_group))


def shard_optimizer_state(state: Dict[str, Any], model: nn.Module, sharded: Dict[str, int],
                          grid: Grid) -> Dict[str, Any]:
    """A one-process optimizer ``state_dict`` cut to this rank's shards, for
    ``optimizer.load_state_dict`` (segtpu's ``tp_shard_state(fresh=False)``)."""
    return _map_moments(state, _param_dims(model, sharded),
                        lambda v, d: _cut(v, d, grid.model_rank, grid.model_size))
