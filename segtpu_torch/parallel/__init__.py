"""Ranks, process groups and the collectives of the port's parallel modes
(counterpart of segtpu/parallel/__init__.py).

segtpu lays its devices out as a (data, model) mesh and lets XLA insert the
collectives of a step written over logically-global arrays. Here each rank
is one process, and the collectives are explicit:

  * :class:`Grid` is the (data, model) grid of the ranks, model-axis
    neighbours contiguous as in segtpu's ``make_mesh``: rank
    ``r = data_rank * model_size + model_rank``. It holds the process group
    of each axis that this rank belongs to.
  * Data parallel: every rank keeps its contiguous slice of each global
    batch (:func:`shard_batch`, or the loaders' ``process_index``), the
    BatchNorms reduce their statistics over the data group
    (:mod:`segtpu_torch.ops.abn`), the losses and metrics finish from sums
    over the data group (:func:`reduce_sum`), and the gradients are summed
    over it (:func:`all_reduce_gradients`). N ranks then compute the step of
    one process on the global batch.
  * Model (tensor) parallel: :mod:`segtpu_torch.parallel.tensor`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid. ``data_group`` spans the
    ranks with this rank's model index (None when the data axis has size 1),
    ``model_group`` those with its data index (None for size 1)."""

    rank: int = 0
    world: int = 1
    model_size: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_size(self) -> int:
        return self.world // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_grid(model_parallel: int = 1) -> Grid:
    """The grid over the default process group, or the one-rank grid when
    no group is initialised. Every rank calls it, in the same order as its
    other group creations (``new_group`` is collective)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs {model_parallel} ranks; "
                             "this process runs alone")
        return Grid()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"{world} ranks are not divisible by model_parallel={model_parallel}")
    n_data = world // model_parallel
    data_group = model_group = None
    if n_data > 1:
        if model_parallel == 1:
            data_group = dist.group.WORLD
        else:
            for m in range(model_parallel):
                g = dist.new_group([d * model_parallel + m for d in range(n_data)])
                if rank % model_parallel == m:
                    data_group = g
    if model_parallel > 1:
        for d in range(n_data):
            g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
            if rank // model_parallel == d:
                model_group = g
    return Grid(rank, world, model_parallel, data_group, model_group)


def fit_data_parallel(batch_size: int, available: int) -> int:
    """Largest rank count <= ``available`` that divides the global batch."""
    for n in range(min(batch_size, available), 0, -1):
        if batch_size % n == 0:
            return n
    return 1


def process_slot(batch_size: int, process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> Tuple[int, int, int]:
    """``(index, count, local batch)`` of a loader that builds slice
    ``index`` of ``count`` of each global batch of ``batch_size``; the index
    and count default to the default process group's rank and size, or 0
    and 1 without one."""
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} outside [0, {process_count})")
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by {process_count} processes")
    return process_index, process_count, batch_size // process_count


def shard_batch(batch: Sequence, grid: Grid) -> tuple:
    """This rank's contiguous slice of each array of a global batch (the
    slice of data rank d is rows ``[d*k, (d+1)*k)``, k = batch / data size)."""
    out = []
    for a in batch:
        n = a.shape[0]
        if n % grid.data_size:
            raise ValueError(f"global batch {n} is not divisible by {grid.data_size} data ranks")
        k = n // grid.data_size
        out.append(a[grid.data_rank * k:(grid.data_rank + 1) * k])
    return tuple(out)


def _bucketed(tensors: Iterable[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flat buffer per (dtype, device) of
    ``tensors``, copied back in place."""
    buckets = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_(tensors: Iterable[torch.Tensor], group, op=dist.ReduceOp.SUM) -> None:
    """All-reduce ``tensors`` in place over ``group``: one flat buffer and
    one collective per dtype."""
    _bucketed(tensors, lambda flat: dist.all_reduce(flat, op=op, group=group))


def all_reduce_gradients(params: Iterable[nn.Parameter], group) -> None:
    """Sum every parameter's ``.grad`` over ``group``, in one bucket per dtype."""
    all_reduce_([p.grad for p in params if p.grad is not None], group)


def replicate(module: nn.Module, group=None) -> None:
    """Broadcast rank 0's parameters and buffers to every rank of ``group``
    (default: all ranks), so that all ranks start from the same weights."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    tensors: List[torch.Tensor] = [t.data for t in module.parameters()] + list(module.buffers())
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


class _ReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the gradient passes through unchanged.
    Every rank finishes the same function of the sum, so the gradient each
    rank holds for its own partial is the true one, and the gradient
    all-reduce adds the ranks' shares once."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(t: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """``t`` summed over ``group`` (differentiable); ``t`` itself for None."""
    if group is None:
        return t
    return _ReduceSum.apply(t, group)


def global_sums(group: Optional[Any], *terms: torch.Tensor) -> List[torch.Tensor]:
    """``sum(t)`` of each term, added over ``group``'s ranks in one
    differentiable all-reduce (:func:`reduce_sum`) when a group is given."""
    sums = [torch.sum(t) for t in terms]
    if group is None:
        return sums
    return list(reduce_sum(torch.stack(sums), group).unbind())


def group_size(group: Optional[Any]) -> int:
    return 1 if group is None else dist.get_world_size(group)
