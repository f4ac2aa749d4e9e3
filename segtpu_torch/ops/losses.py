"""Binary segmentation losses (counterpart of segtpu/ops/losses.py:27-124,
247-264; reference lib/losses.py).

Every reduction is global over the batch, not per sample, and the
reference's quirks are kept:

  * ``bce`` is BCEWithSigmoidLoss (reference lib/losses.py:46-53): the logits
    go through ``logsigmoid`` and the result is fed to BCE-with-logits again
    (a double squash). The conventional loss is :func:`bce_with_logits`.
  * ``focal`` (lib/losses.py:78-101) uses the same logsigmoid-then-BCE
    pattern, and the registry builds it with ``size_average=False``: a sum.
  * ``bce_jaccard`` is BCEWithLogitsLossAndSmoothJaccard (lib/losses.py:56-75):
    weights (1, 0.5), normalised by their sum.

Each function takes ``logits`` and ``targets`` of one shape (NCHW, C = 1)
and returns a scalar tensor. The multiclass losses are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7


def _bce_with_logits_elementwise(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """softplus(x) - x*t, the stable elementwise BCE-with-logits."""
    return F.softplus(x) - x * t


def dice_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 - 2*I/(sum_p + sum_t + eps) on sigmoid probabilities (lib/losses.py:7-15)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    return 1.0 - 2.0 * torch.sum(p * t) / (torch.sum(p) + torch.sum(t) + _EPS)


def jaccard_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """1 - I/(U - I + eps) (lib/losses.py:18-28)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t)
    return 1.0 - intersection / (union - intersection + _EPS)


def smooth_jaccard_loss(logits: torch.Tensor, targets: torch.Tensor,
                        smooth: float = 100.0) -> torch.Tensor:
    """Additively smoothed Jaccard (lib/losses.py:31-43, smooth 100)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t)
    return 1.0 - (intersection + smooth) / (union - intersection + smooth)


def bce_with_sigmoid_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The reference's registered ``bce``: logsigmoid first, then
    BCE-with-logits on the result, mean reduction (lib/losses.py:46-53)."""
    x = F.logsigmoid(logits)
    return torch.mean(_bce_with_logits_elementwise(x, targets.to(x.dtype)))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Conventional BCE-with-logits, mean reduction."""
    return torch.mean(_bce_with_logits_elementwise(logits, targets.to(logits.dtype)))


def bce_smooth_jaccard_loss(logits: torch.Tensor, targets: torch.Tensor,
                            bce_weight: float = 1.0, jaccard_weight: float = 0.5) -> torch.Tensor:
    """BCEWithLogitsLossAndSmoothJaccard (lib/losses.py:56-75)."""
    loss1 = bce_with_sigmoid_loss(logits, targets) * bce_weight
    loss2 = smooth_jaccard_loss(logits, targets) * jaccard_weight
    return (loss1 + loss2) / (bce_weight + jaccard_weight)


def focal_loss_binary(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                      size_average: bool = False) -> torch.Tensor:
    """Binary focal loss with the logsigmoid-then-BCE squash; the registry's
    ``size_average=False`` makes it a sum (lib/losses.py:78-101)."""
    x = F.logsigmoid(logits)
    logpt = -_bce_with_logits_elementwise(x, targets.to(x.dtype))
    loss = -((1.0 - torch.exp(logpt)) ** gamma) * logpt
    return torch.mean(loss) if size_average else torch.sum(loss)


LOSS_REGISTRY = {
    "jaccard": jaccard_loss,
    "bce_jaccard": bce_smooth_jaccard_loss,
    "focal": focal_loss_binary,          # sum reduction, as registered
    "bce": bce_with_sigmoid_loss,        # the reference's double-squash bce
    # beyond the reference registry (non-quirk variants):
    "dice": dice_loss,
    "bce_logits": bce_with_logits,
    "smooth_jaccard": smooth_jaccard_loss,
}


def get_loss(name: str):
    """name -> loss function (reference torch_train.py:82-97)."""
    key = name.lower()
    if key not in LOSS_REGISTRY:
        raise ValueError(name)
    return LOSS_REGISTRY[key]
