"""Host-side running meters (copy of segtpu/ops/meters.py; reference
lib/train_utils.py:14-33, 92-131). NumPy only."""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Running average with identical semantics to the reference AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        return "%.3f" % self.avg

    def __repr__(self):
        return f"AverageMeter(avg={self.avg:.6f}, count={self.count})"


class PRCurveMeter:
    """Accumulates tp/tn/fp/fn over a 127-threshold sweep.

    The counting runs on the device (:func:`segtpu_torch.ops.metrics.pr_curve_counts`);
    ``update_counts`` takes the four count arrays, not raw predictions.
    """

    def __init__(self, n_thresholds: int = 127):
        self.n_thresholds = n_thresholds
        self.thresholds = np.arange(0.0, 1.0, 1.0 / n_thresholds, dtype=np.float32)
        self.tp = np.zeros(n_thresholds, dtype=np.uint64)
        self.tn = np.zeros(n_thresholds, dtype=np.uint64)
        self.fp = np.zeros(n_thresholds, dtype=np.uint64)
        self.fn = np.zeros(n_thresholds, dtype=np.uint64)

    def reset(self):
        self.tp.fill(0)
        self.tn.fill(0)
        self.fp.fill(0)
        self.fn.fill(0)

    def update_counts(self, tp, tn, fp, fn):
        self.tp += np.asarray(tp, dtype=np.uint64)
        self.tn += np.asarray(tn, dtype=np.uint64)
        self.fp += np.asarray(fp, dtype=np.uint64)
        self.fn += np.asarray(fn, dtype=np.uint64)

    def precision(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.divide(self.tp, self.tp + self.fp)

    def recall(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.divide(self.tp, self.tp + self.fn)
