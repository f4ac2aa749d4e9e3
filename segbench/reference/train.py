"""Training steps, plain: the two losses, the two optimizers and the step
that segtpu's recipe runs (reference torch_train.py:176-214): forward,
loss, the backward of ``batch_size * loss``, the optimizer's update.

Losses (reference lib/losses.py), global means over the batch:

* ``bce``: BCEWithSigmoidLoss, the logits through ``logsigmoid`` and the
  result fed to BCE-with-logits again (the reference's double squash);
* ``bce_jaccard``: ``(bce + 0.5 * smooth Jaccard) / 1.5``, the BCE on
  ``logsigmoid`` as above, the Jaccard on the sigmoid with smoothing 100.

Optimizers with torch's defaults (reference torch_train.py:67-79): SGD
without momentum; Adam with betas (0.9, 0.999), eps 1e-8 outside the
square root, bias corrections.

A recipe with ``freeze_encoder`` trains with the encoder frozen, as the
reference's ``--freeze-encoder`` does: the parameters under the
configuration's ``architecture.encoder_prefixes`` get a gradient of nought
before each update (segtpu's mask rule), so Adam's state for them stays
nought and they do not move, while the encoder's BatchNorms still update
their running statistics in training mode.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.numerics import Numerics, default_generator, dropout_seed

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def _bce_on_logsigmoid(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = F.logsigmoid(logits)
    return F.softplus(x) - x * y


def loss(name: str, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if name == "bce":
        return _bce_on_logsigmoid(logits, y).mean()
    if name == "bce_jaccard":
        bce = _bce_on_logsigmoid(logits, y).mean()
        p = torch.sigmoid(logits)
        inter, union = (p * y).sum(), p.sum() + y.sum()
        jaccard = 1.0 - (inter + 100.0) / (union - inter + 100.0)
        return (bce + 0.5 * jaccard) / 1.5
    raise ValueError(f"no reference loss {name!r}")


class Optimizer:
    """``name`` ``sgd`` or ``adam`` over ``params`` (name -> parameter)."""

    def __init__(self, name: str, params: Dict[str, nn.Parameter], lr: float):
        if name not in ("sgd", "adam"):
            raise ValueError(f"no reference optimizer {name!r}")
        self.name, self.params, self.lr, self.t = name, params, lr, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()} if name == "adam" else {}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()} if name == "adam" else {}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = ADAM_BETAS
        for n, p in self.params.items():
            g = p.grad
            if self.name == "sgd":
                p.sub_(self.lr * g)
                continue
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + ADAM_EPS))


def frozen_prefixes(config: dict) -> Tuple[str, ...]:
    """The name prefixes of the parameters that a configuration's recipe
    freezes: its ``architecture.encoder_prefixes`` under ``freeze_encoder``,
    else none."""
    if not config["train"].get("freeze_encoder"):
        return ()
    return tuple(config["architecture"]["encoder_prefixes"])


def run_steps(model: nn.Module, batches: List[Tuple[torch.Tensor, torch.Tensor]], recipe: dict,
              seed: int, nx: Numerics, frozen: Tuple[str, ...] = ()) -> dict:
    """``len(batches)`` training steps of ``model`` from its present weights,
    step ``t`` on ``batches[t]`` with its dropout drawn from the step's seed
    (:func:`~segbench.reference.numerics.dropout_seed` of ``seed`` and
    ``t``), its forward in ``nx``'s precision; the parameters whose names
    start with one of ``frozen`` are frozen (module docstring). Returns
    each step's loss, the first step's logits, each trained parameter's
    first gradient (of ``batch_size * loss``), each parameter's change over
    all the steps and its norm before them, as norms by name, and the names
    of the frozen parameters."""
    params = dict(model.named_parameters())
    still = {n: p for n, p in params.items() if n.startswith(frozen)}
    trained = {n: p for n, p in params.items() if n not in still}
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = Optimizer(recipe["optimizer"], params, recipe["lr"])
    # nothing upstream of a frozen parameter needs its gradient, which is nought
    for p in still.values():
        p.requires_grad_(False)
    model.train()
    losses, first, logits = [], None, None
    for t, (x, y) in enumerate(batches):
        for p in trained.values():
            p.grad = None
        for p in still.values():
            p.grad = torch.zeros_like(p)
        default_generator(x.device).manual_seed(dropout_seed(seed, t))
        z = nx.forward(model, x)
        value = loss(recipe["loss"], z, y)
        (value * x.shape[0]).backward()
        losses.append(float(value.detach()))
        if first is None:
            logits = z.detach()
            first = {n: float(p.grad.norm()) for n, p in trained.items()}
        opt.step()
    change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    norm = {n: float(p.norm()) for n, p in start.items()}
    return {"losses": losses, "logits": logits, "grad": first, "change": change, "norm": norm,
            "frozen": sorted(still)}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], grad: Dict[str, float],
              floor: float = 1e-3) -> Tuple[float, str, float]:
    """``|program - reference|`` of each leaf against the larger of its
    reference value and the median leaf's, over the leaves that have a
    reference gradient (:func:`run_steps` gives the frozen none) of at least
    ``floor`` of the median leaf's (a bias ahead of a
    batch statistic has a gradient of nought but for rounding, and moves
    under Adam by rounding alone). Returns the largest gap, its leaf, and
    the median gap."""
    med_grad = sorted(grad.values())[len(grad) // 2]
    kept = [n for n in grad if grad[n] >= floor * med_grad]
    med = sorted(reference[n] for n in kept)[len(kept) // 2]
    gaps = []
    for n in kept:
        gap = abs(program[n] - reference[n]) / max(reference[n], med)
        gaps.append((gap if math.isfinite(gap) else math.inf, n))
    worst, leaf = max(gaps)
    return worst, leaf, sorted(g for g, _ in gaps)[len(gaps) // 2]
