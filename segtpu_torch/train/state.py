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
loop's image and histogram logging.

``augment_fn`` (segtpu's device augmentations, segtpu/train/state.py:96-98)
runs on the raw batch in fp32, before autocast and the model. Its draws come
from a ``torch.Generator`` on the batch's device, seeded for each step from
(run seed, 7, step) as segtpu folds 7 and ``state.step`` into its key: a run
resumed at step k draws what an unbroken run draws at step k.
"""

from __future__ import annotations

from typing import AbstractSet, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from segtpu_torch.ops.metrics import pr_curve_counts
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


def augment_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s augmentation generator in a run seeded
    ``seed``: a hash of (seed, 7, step) on the host, no device work."""
    return int(np.random.SeedSequence([seed, 7, step]).generate_state(1, np.uint64)[0] >> 1)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                    metrics: Optional[Dict[str, Callable]] = None, bf16: bool = False,
                    trainable_mask: Optional[AbstractSet[str]] = None,
                    param_penalty: Optional[Callable[[nn.Module], torch.Tensor]] = None,
                    augment_fn: Optional[Callable] = None, seed: int = 42,
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
    already taken."""
    metrics = metrics or {}
    frozen = []
    if trainable_mask is not None:
        names = dict(model.named_parameters())
        unknown = set(trainable_mask) - set(names)
        if unknown:
            raise ValueError(f"trainable_mask names no parameter of the model: {sorted(unknown)}")
        frozen = [p for n, p in names.items() if n not in trainable_mask]

    generators: Dict[torch.device, torch.Generator] = {}

    def train_step(x: torch.Tensor, y: torch.Tensor, lr: float) -> Logs:
        model.train()
        if augment_fn is not None:
            g = generators.get(x.device)
            if g is None:
                g = generators[x.device] = torch.Generator(device=x.device)
            g.manual_seed(augment_seed(seed, train_step.step))
            x, y = augment_fn(g, x.float(), y.float())
        train_step.step += 1
        x = _model_input(x)
        set_learning_rate(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(x)
        loss = loss_fn(logits, y)
        total = loss * x.shape[0]
        if param_penalty is not None:
            total = total + param_penalty(model)
        total.backward()
        for p in frozen:
            if p.grad is not None:
                p.grad.zero_()
        logs = {"loss": loss.detach(),
                "grad_absmax": grad_absmax(p.grad for p in model.parameters())}
        optimizer.step()
        with torch.no_grad():
            for name, fn in metrics.items():
                logs[name] = fn(logits.detach(), y)
        return logs

    train_step.model = model
    train_step.step = 0
    return train_step


def make_eval_step(model: nn.Module, loss_fn: Callable,
                   metrics: Optional[Dict[str, Callable]] = None, bf16: bool = False,
                   with_pr_curve: bool = False) -> Callable[[torch.Tensor, torch.Tensor], Logs]:
    """``step(x, y) -> logs``: loss and metrics of ``model`` in eval mode,
    with its running statistics (the reference's validate(),
    torch_train.py:240-305). Logs are 0-d tensors on the device. ``bf16``
    runs the forward under bfloat16 autocast, as the train step's.
    ``with_pr_curve`` adds ``logs["pr_counts"]``, the ``(tp, tn, fp, fn)`` of
    :func:`~segtpu_torch.ops.metrics.pr_curve_counts`."""
    metrics = metrics or {}

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
                logs["pr_counts"] = pr_curve_counts(logits, y)
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
