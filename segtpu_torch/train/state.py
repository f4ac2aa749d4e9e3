"""Train, eval and predict steps (counterpart of segtpu/train/state.py).

The reference's inner loop (torch_train.py:176-214): forward, loss,
``(batch_size * loss).backward()``, ``optimizer.step()``, the per-batch
metrics and the gradient abs-max. segtpu compiles it into one jitted
program; here it is one eager call whose logs stay tensors on the device,
so the step never waits for the card. The caller reads them when it needs
them.

On CUDA the input is handed to the model in ``channels_last`` memory, the
layout the model is kept in. ``bf16`` runs the model's forward under
bfloat16 autocast. The model returns fp32 logits (float64 from a float64
model), and the loss and metrics are taken on them outside autocast.

Each step function carries its model as ``step.model``, for the epoch
loop's image and histogram logging. The train step and its phases are
spans of :mod:`segtpu_torch.spans` (``segtpu_torch.step``, keyed by the
step's index, and ``segtpu_torch.step.<phase>`` inside it).

``augment_fn`` (segtpu's device augmentations, segtpu/train/state.py:96-98)
runs on the raw batch in fp32, before autocast and the model. Its draws come
from a ``torch.Generator`` on the batch's device, seeded for each step from
(run seed, 7, step) as segtpu folds 7 and ``state.step`` into its key: a run
resumed at step k draws what an unbroken run draws at step k.

Dropout is keyed by step too (segtpu's ``fold_in(rng, state.step)``,
segtpu/train/state.py:99): for each step's forward and backward the default
generator of the batch's device is seeded from (run seed, 11, step),
:func:`dropout_seed`, and it gets its own state back after.
``torch.utils.checkpoint`` saves and restores that generator's state around
a recomputed block, so a block under ``remat`` draws the same masks again.

Data parallel (``grid`` with a data axis, :mod:`segtpu_torch.parallel`):
each rank holds its slice of the global batch; the loss and the metrics
finish from sums over the data group, the gradients are those of
``loss * global batch`` summed over it, and ``grad_absmax`` is taken after
that sum. Every rank seeds dropout alike and the dropouts keep their rank's
rows of the global batch's mask, so N ranks draw one process's masks. The
device augmentations draw per rank, from (run seed, 7, step, data rank).
"""

from __future__ import annotations

import contextlib
import functools
from typing import AbstractSet, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from segtpu_torch import spans
from segtpu_torch.ops.metrics import pr_curve_counts
from segtpu_torch.parallel import Grid, all_reduce_gradients
from segtpu_torch.train.optim import set_learning_rate

Logs = Dict[str, torch.Tensor]


def _model_input(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return x.contiguous(memory_format=torch.channels_last)
    return x


def grad_absmax(grads) -> torch.Tensor:
    """Largest |g| over every gradient tensor: the reference's explosion
    tripwire (torch_train.py:199-205), a few reductions on the device."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm(grads, float("inf"))).max()


def _key(*entropy: int) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0] >> 1)


def augment_seed(seed: int, step: int, data_rank: Optional[int] = None) -> int:
    """The seed of step ``step``'s augmentation generator in a run seeded
    ``seed``: a hash of (seed, 7, step) on the host, no device work; with
    ``data_rank``, of (seed, 7, step, data_rank)."""
    return _key(seed, 7, step) if data_rank is None else _key(seed, 7, step, data_rank)


def dropout_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s dropout stream in a run seeded ``seed``: a
    hash of (seed, 11, step), a key of its own beside :func:`augment_seed`."""
    return _key(seed, 11, step)


@contextlib.contextmanager
def seeded_device_generator(device: torch.device, seed: int) -> Iterator[None]:
    """Seed the default generator of ``device`` (the one dropout draws from)
    for the block, and give it back its state after, so that torch's other
    draws in the process do not follow the step's key."""
    gen = torch.cuda.default_generators[device.index] if device.type == "cuda" \
        else torch.default_generator
    saved = gen.get_state()
    gen.manual_seed(seed)
    try:
        yield
    finally:
        gen.set_state(saved)


def _on_group(fn: Callable, group) -> Callable:
    """``fn`` with its batch sums taken over ``group`` (losses and metrics
    take ``group=``)."""
    return fn if group is None else functools.partial(fn, group=group)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                    metrics: Optional[Dict[str, Callable]] = None, bf16: bool = False,
                    trainable_mask: Optional[AbstractSet[str]] = None,
                    param_penalty: Optional[Callable[[nn.Module], torch.Tensor]] = None,
                    augment_fn: Optional[Callable] = None, seed: int = 42,
                    grid: Optional[Grid] = None,
                    ) -> Callable[[torch.Tensor, torch.Tensor, float], Logs]:
    """``step(x, y, lr) -> logs``: one training step of ``model`` in place.

    ``x``: NCHW float32 images, ``y``: NCHW targets, both on the model's
    device; ``lr``: this step's learning rate (a host float). The gradients
    are those of ``batch_size * loss``, as the reference's. ``logs`` holds
    ``loss``, ``grad_absmax`` and each metric, as 0-d tensors on the device;
    the parameters' ``.grad`` keep this step's gradients.

    ``trainable_mask``: the names (``model.named_parameters()``) of the
    parameters that train. Every other parameter's gradient is zeroed after
    the backward and before ``optimizer.step()``, as segtpu multiplies its
    gradients by the mask (segtpu/train/state.py:117-121); the gradient is
    not dropped (``None``), which would change what torch's optimizers keep
    per parameter. ``param_penalty(model) -> 0-d tensor`` is added to
    ``batch_size * loss`` before the backward (the regularised trainer,
    reference torch_train_reg.py:92-97); the logged ``loss`` stays the
    unscaled loss. ``grad_absmax`` is taken after the mask.

    ``augment_fn(generator, x, y) -> (x, y)``: an on-device augmentation
    (:func:`segtpu_torch.augment.device.get_device_pipelines`) of the raw
    batch, in fp32, before the model; its generator is seeded with
    :func:`augment_seed` of ``seed`` and the step's index, ``step.step``,
    which counts the calls and which a resumed run sets to the steps
    already taken. The dropout masks of the step, in its forward and
    backward, come from the default generator of ``x``'s device seeded
    with :func:`dropout_seed` of the same index: they are a function of
    (``seed``, step) alone, the same in every run with that seed, and in a
    resumed run as in an unbroken one. The generator gets its state back
    after the backward, so other draws in the process are left as they were.

    ``grid``: the ranks' (data, model) grid (:func:`segtpu_torch.parallel.make_grid`);
    ``x``/``y`` are then this rank's slice of the global batch, and
    ``loss_fn`` and the metrics take ``group=``."""
    grid = grid or Grid()
    group = grid.data_group
    loss_fn = _on_group(loss_fn, group)
    metrics = {k: _on_group(fn, group) for k, fn in (metrics or {}).items()}
    frozen = []
    if trainable_mask is not None:
        names = dict(model.named_parameters())
        unknown = set(trainable_mask) - set(names)
        if unknown:
            raise ValueError(f"trainable_mask names no parameter of the model: {sorted(unknown)}")
        frozen = [p for n, p in names.items() if n not in trainable_mask]

    generators: Dict[torch.device, torch.Generator] = {}

    def train_step(x: torch.Tensor, y: torch.Tensor, lr: float) -> Logs:
        step = train_step.step
        with spans.span("segtpu_torch.step", step, device=True):
            model.train()
            if augment_fn is not None:
                with spans.span("segtpu_torch.step.augment", step):
                    g = generators.get(x.device)
                    if g is None:
                        g = generators[x.device] = torch.Generator(device=x.device)
                    g.manual_seed(augment_seed(seed, step,
                                               grid.data_rank if group is not None else None))
                    x, y = augment_fn(g, x.float(), y.float())
            train_step.step += 1
            x = _model_input(x)
            set_learning_rate(optimizer, lr)
            optimizer.zero_grad(set_to_none=True)
            # the forward, and the backward that may recompute it (remat), draw
            # their dropout masks from the step's key
            with seeded_device_generator(x.device, dropout_seed(seed, step)):
                with spans.span("segtpu_torch.step.forward", step):
                    with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
                        logits = model(x)
                with spans.span("segtpu_torch.step.loss", step):
                    loss = loss_fn(logits, y)
                with spans.span("segtpu_torch.step.backward", step):
                    total = loss * (x.shape[0] * grid.data_size)
                    if param_penalty is not None:
                        total = total + param_penalty(model) / grid.data_size
                    total.backward()
            if group is not None:
                with spans.span("segtpu_torch.step.reduce", step):
                    all_reduce_gradients(model.parameters(), group)
            with spans.span("segtpu_torch.step.optimizer", step):
                for p in frozen:
                    if p.grad is not None:
                        p.grad.zero_()
                absmax = grad_absmax(p.grad for p in model.parameters())
                if grid.model_group is not None:
                    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=grid.model_group)
                optimizer.step()
            logs = {"loss": loss.detach(), "grad_absmax": absmax}
            with spans.span("segtpu_torch.step.metrics", step), torch.no_grad():
                for name, fn in metrics.items():
                    logs[name] = fn(logits.detach(), y)
            return logs

    train_step.model = model
    train_step.step = 0
    return train_step


def make_eval_step(model: nn.Module, loss_fn: Callable,
                   metrics: Optional[Dict[str, Callable]] = None, bf16: bool = False,
                   with_pr_curve: bool = False, grid: Optional[Grid] = None,
                   ) -> Callable[[torch.Tensor, torch.Tensor], Logs]:
    """``step(x, y) -> logs``: loss and metrics of ``model`` in eval mode,
    with its running statistics (the reference's validate(),
    torch_train.py:240-305). Logs are 0-d tensors on the device. ``bf16``
    runs the forward under bfloat16 autocast, as the train step's.
    ``with_pr_curve`` adds ``logs["pr_counts"]``, the ``(tp, tn, fp, fn)`` of
    :func:`~segtpu_torch.ops.metrics.pr_curve_counts`. ``grid``: as
    :func:`make_train_step`'s; the logs are those of the global batch."""
    group = (grid or Grid()).data_group
    loss_fn = _on_group(loss_fn, group)
    metrics = {k: _on_group(fn, group) for k, fn in (metrics or {}).items()}
    pr_counts = _on_group(pr_curve_counts, group)

    def eval_step(x: torch.Tensor, y: torch.Tensor) -> Logs:
        model.eval()
        with torch.inference_mode():
            x = _model_input(x)
            with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
                logits = model(x)
            logs = {"loss": loss_fn(logits, y)}
            for name, fn in metrics.items():
                logs[name] = fn(logits, y)
            if with_pr_curve:
                logs["pr_counts"] = pr_counts(logits, y)
        return logs

    eval_step.model = model
    return eval_step


def make_predict_step(model: nn.Module, bf16: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> sigmoid(model(x))`` under ``torch.inference_mode()``.

    ``x``: NCHW float32 on the model's device; the result is NCHW float32
    probabilities. ``bf16`` runs the model under bfloat16 autocast (the
    submit CLI's ``--bf16``)."""
    model.eval()

    def predict_step(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = _model_input(x)
            with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
                logits = model(x)
            return torch.sigmoid(logits.float())

    return predict_step
