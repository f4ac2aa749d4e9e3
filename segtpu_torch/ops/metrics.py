"""Segmentation metrics as tensors on the device (counterpart of
segtpu/ops/metrics.py:16-50; reference lib/metrics.py).

Each returns tensors on the logits' device and reads nothing back to the
host, so a train or eval step can log them without a synchronisation. Given
``group`` (data parallel), each takes its batch sums over the group's ranks
and gives the metric of the global batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from segtpu_torch.parallel import global_sums, group_size

_EPS = 1e-7


def jaccard_score(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Soft IoU on sigmoid probabilities, global reduction (lib/metrics.py:9-23)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection, sum_p, sum_t = global_sums(group, p * t, p, t)
    union = sum_p + sum_t
    return intersection / (union - intersection + _EPS)


def pixel_accuracy(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Thresholded (0.5) pixelwise accuracy (lib/metrics.py:26-43)."""
    pred = torch.sigmoid(logits) > 0.5
    t = targets if targets.dtype == torch.bool else targets > 0.5
    (hits,) = global_sums(group, (pred == t).float())
    return hits / (targets.numel() * group_size(group))


def hard_iou(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Hard (thresholded) IoU, beyond the reference's set."""
    pred = (torch.sigmoid(logits) > threshold).float()
    t = targets.float()
    intersection = torch.sum(pred * t)
    union = torch.sum(pred) + torch.sum(t) - intersection
    return intersection / (union + _EPS)


METRIC_REGISTRY = {
    "iou": jaccard_score,
    "accuracy": pixel_accuracy,
}


def default_metrics():
    """The reference's metric set: {'iou', 'accuracy'} (torch_train.py:376)."""
    return dict(METRIC_REGISTRY)


def pr_curve_counts(logits: torch.Tensor, targets: torch.Tensor, n_thresholds: int = 127,
                    group=None):
    """Confusion counts over a threshold sweep (segtpu/ops/metrics.py:53-89;
    reference lib/train_utils.py:92-131): ``(tp, tn, fp, fn)``, int32 tensors
    of shape ``(n_thresholds,)`` on the logits' device, at thresholds
    ``arange(n) / n``.

    A pixel whose probability lies above ``k`` thresholds (``searchsorted``,
    left side) is positive for thresholds ``0 .. k-1``: the pixels are
    counted per (k, target) with one scatter-add, and suffix sums give the
    counts per threshold. No boolean indexing, so no host round-trip.
    ``group``: the counts of the global batch."""
    p = torch.sigmoid(logits.float()).reshape(-1)
    t = (targets.reshape(-1) > 0.5).long()
    thresholds = torch.arange(n_thresholds, dtype=torch.float32, device=p.device) / n_thresholds
    n_above = torch.searchsorted(thresholds, p, right=False)  # in [0, n]
    counts = torch.zeros(2 * (n_thresholds + 1), dtype=torch.int64, device=p.device)
    counts.scatter_add_(0, n_above + (n_thresholds + 1) * t, torch.ones_like(n_above))
    if group is not None:
        dist.all_reduce(counts, group=group)
    neg_bins, pos_bins = counts[1:n_thresholds + 1], counts[n_thresholds + 2:]
    tp = pos_bins.flip(0).cumsum(0).flip(0)
    fp = neg_bins.flip(0).cumsum(0).flip(0)
    n_pos = counts[n_thresholds + 1:].sum()
    n_neg = counts[:n_thresholds + 1].sum()
    return tuple(v.to(torch.int32) for v in (tp, n_neg - fp, fp, n_pos - tp))
