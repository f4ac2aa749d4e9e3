"""Segmentation metrics as tensors on the device (counterpart of
segtpu/ops/metrics.py:16-50; reference lib/metrics.py).

Each returns a scalar tensor and reads nothing back to the host, so a train
step can log them without a synchronisation. ``pr_curve_counts`` is not
ported yet.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def jaccard_score(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Soft IoU on sigmoid probabilities, global reduction (lib/metrics.py:9-23)."""
    p = torch.sigmoid(logits)
    t = targets.to(p.dtype)
    intersection = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t)
    return intersection / (union - intersection + _EPS)


def pixel_accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Thresholded (0.5) pixelwise accuracy (lib/metrics.py:26-43)."""
    pred = torch.sigmoid(logits) > 0.5
    t = targets if targets.dtype == torch.bool else targets > 0.5
    return torch.sum((pred == t).float()) / targets.numel()


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
