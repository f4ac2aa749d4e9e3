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

Each binary loss takes ``logits`` and ``targets`` of one shape (NCHW,
C = 1) and returns a scalar tensor. Given ``group`` (data parallel), a
binary loss takes its batch sums (``sum p*t``, ``sum p``, ``sum t``, the
BCE sum and the element count) over the ranks of the group in one
all-reduce, and finishes from the global sums: the loss of the global batch,
as segtpu computes it on its logically-global arrays. The multiclass losses (reference
lib/losses.py:105-232, segtpu/ops/losses.py:132-240) take NCHW class scores
and ``[N, H, W]`` integer class ids; like the reference's, they are not in
the registry.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from segtpu_torch.parallel import global_sums as _sums
from segtpu_torch.parallel import group_size

_EPS = 1e-7


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """``mean(x)`` over the global batch of ``group``'s ranks (equal shards)."""
    if group is None:
        return torch.mean(x)
    (total,) = _sums(group, x)
    return total / (x.numel() * group_size(group))


def _smooth_jaccard(intersection, sum_p, sum_t, smooth: float) -> torch.Tensor:
    union = sum_p + sum_t
    return 1.0 - (intersection + smooth) / (union - intersection + smooth)


def _bce_with_logits_elementwise(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """softplus(x) - x*t, the stable elementwise BCE-with-logits."""
    return F.softplus(x) - x * t


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """1 - 2*I/(sum_p + sum_t + eps) on sigmoid probabilities (lib/losses.py:7-15)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection, sum_p, sum_t = _sums(group, p * t, p, t)
    return 1.0 - 2.0 * intersection / (sum_p + sum_t + _EPS)


def jaccard_loss(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """1 - I/(U - I + eps) (lib/losses.py:18-28)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection, sum_p, sum_t = _sums(group, p * t, p, t)
    union = sum_p + sum_t
    return 1.0 - intersection / (union - intersection + _EPS)


def smooth_jaccard_loss(logits: torch.Tensor, targets: torch.Tensor,
                        smooth: float = 100.0, group=None) -> torch.Tensor:
    """Additively smoothed Jaccard (lib/losses.py:31-43, smooth 100)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    return _smooth_jaccard(*_sums(group, p * t, p, t), smooth)


def bce_with_sigmoid_loss(logits: torch.Tensor, targets: torch.Tensor,
                          group=None) -> torch.Tensor:
    """The reference's registered ``bce``: logsigmoid first, then
    BCE-with-logits on the result, mean reduction (lib/losses.py:46-53)."""
    x = F.logsigmoid(logits)
    return _mean(_bce_with_logits_elementwise(x, targets.to(x.dtype)), group)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Conventional BCE-with-logits, mean reduction."""
    return _mean(_bce_with_logits_elementwise(logits, targets.to(logits.dtype)), group)


def bce_smooth_jaccard_loss(logits: torch.Tensor, targets: torch.Tensor,
                            bce_weight: float = 1.0, jaccard_weight: float = 0.5,
                            group=None) -> torch.Tensor:
    """BCEWithLogitsLossAndSmoothJaccard (lib/losses.py:56-75). Under a
    group its four batch sums go in one all-reduce."""
    x = F.logsigmoid(logits)
    bce = _bce_with_logits_elementwise(x, targets.to(x.dtype))
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    if group is None:
        bce_mean, jaccard_sums = torch.mean(bce), _sums(None, p * t, p, t)
    else:
        bce_sum, *jaccard_sums = _sums(group, bce, p * t, p, t)
        bce_mean = bce_sum / (bce.numel() * group_size(group))
    loss1 = bce_mean * bce_weight
    loss2 = _smooth_jaccard(*jaccard_sums, 100.0) * jaccard_weight
    return (loss1 + loss2) / (bce_weight + jaccard_weight)


def focal_loss_binary(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                      size_average: bool = False, group=None) -> torch.Tensor:
    """Binary focal loss with the logsigmoid-then-BCE squash; the registry's
    ``size_average=False`` makes it a sum (lib/losses.py:78-101)."""
    x = F.logsigmoid(logits)
    logpt = -_bce_with_logits_elementwise(x, targets.to(x.dtype))
    loss = -((1.0 - torch.exp(logpt)) ** gamma) * logpt
    if size_average:
        return _mean(loss, group)
    return _sums(group, loss)[0]


# ---------------------------------------------------------------------------
# Multiclass losses: scores NCHW (class dim 1), targets [N, H, W] class ids
# ---------------------------------------------------------------------------

Weights = Optional[Union[torch.Tensor, Sequence[float]]]


def _pick(logp: torch.Tensor, targets: torch.Tensor, ignore_index: int):
    """``(log p of each pixel's target class, valid)``; ignored pixels pick
    class 0 and are masked by the caller."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    return logp.gather(1, safe.unsqueeze(1)).squeeze(1), valid, safe


def focal_loss_multi(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                     size_average: bool = True, ignore_index: int = -100,
                     from_logits: bool = False) -> torch.Tensor:
    """Multiclass focal loss (reference lib/losses.py:105-134).
    ``from_logits``: ``logits`` already are log-probabilities. Ignored
    pixels add 0 and the mean divides by every pixel, as torch's
    ``nll_loss(reduce=False)`` then ``mean()``."""
    logp = logits if from_logits else F.log_softmax(logits, dim=1)
    logpt, valid, _ = _pick(logp, targets, ignore_index)
    zero = torch.zeros_like(logpt)
    logpt = torch.where(valid, logpt, zero)
    loss = torch.where(valid, -((1.0 - torch.exp(logpt)) ** gamma) * logpt, zero)
    return torch.mean(loss) if size_average else torch.sum(loss)


def jaccard_loss_multi(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -100,
                       from_logits: bool = False, class_weights: Weights = None,
                       reduce: bool = True, smooth: float = 100.0) -> torch.Tensor:
    """Multiclass smoothed Jaccard (reference lib/losses.py:137-195): per
    class over the non-ignored pixels, 0 for a class absent from the
    target; class weights normalised to sum 1. ``from_logits``: ``logits``
    are log-probabilities. ``reduce=False`` gives the per-class losses."""
    probs = torch.exp(logits) if from_logits else F.softmax(logits, dim=1)
    valid = (targets != ignore_index).to(probs.dtype)
    classes = torch.arange(probs.shape[1], device=probs.device).view(1, -1, 1, 1)
    t = (targets.unsqueeze(1) == classes).to(probs.dtype) * valid.unsqueeze(1)
    p = probs * valid.unsqueeze(1)
    dims = (0, 2, 3)
    num_preds = t.sum(dims)
    intersection = (p * t).sum(dims)
    union = p.sum(dims) + num_preds
    jac = (intersection + smooth) / (union - intersection + smooth)
    loss = torch.where(num_preds == 0, torch.zeros_like(jac), 1.0 - jac)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=loss.dtype, device=loss.device)
        loss = loss * (w / w.sum())
    return loss.sum() if reduce else loss


def focal_and_jaccard_loss_multi(logits: torch.Tensor, targets: torch.Tensor,
                                 jaccard_weight: float = 1.0, class_weights: Weights = None,
                                 ignore_index: int = -1) -> torch.Tensor:
    """Focal + Jaccard over ``1 + jaccard_weight`` (reference lib/losses.py:198-216)."""
    logp = F.log_softmax(logits, dim=1)
    fl = focal_loss_multi(logp, targets, ignore_index=ignore_index, from_logits=True)
    jl = jaccard_loss_multi(logp, targets, ignore_index=ignore_index, from_logits=True,
                            class_weights=class_weights)
    return (fl + jl) / (1.0 + jaccard_weight)


def nll_and_jaccard_loss_multi(logits: torch.Tensor, targets: torch.Tensor,
                               jaccard_weight: float = 1.0, class_weights: Weights = None,
                               ignore_index: int = -1) -> torch.Tensor:
    """NLL + Jaccard over ``1 + jaccard_weight`` (reference lib/losses.py:219-232):
    the NLL's mean divides by the summed pixel weights, an ignored pixel
    weighs 0."""
    logp = F.log_softmax(logits, dim=1)
    picked, valid, safe = _pick(logp, targets, ignore_index)
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=logp.dtype, device=logp.device)
        pix_w = torch.where(valid, w[safe], torch.zeros_like(picked))
    else:
        pix_w = valid.to(logp.dtype)
    nll = -torch.sum(picked * pix_w) / torch.clamp(torch.sum(pix_w), min=_EPS)
    jl = jaccard_loss_multi(logp, targets, ignore_index=ignore_index, from_logits=True,
                            class_weights=class_weights)
    return (nll + jl) / (1.0 + jaccard_weight)


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
