"""Pure-NumPy loss mirrors (a copy of segtpu/ops/numpy_losses.py; reference
lib/numpy_losses.py).

Used by the loss-shape plotting tool (segtpu_torch/reporting/plot_loss.py) and as
independent oracles in the test suite. These operate on *probabilities*
(y_pred in [0, 1]), unlike segtpu_torch.ops.losses, which take logits.

Value-parity notes (verified in tests): the reference's mirrors flatten to
column vectors before reducing — a no-op for global sums, so these compute
directly on the raw arrays; its ``binary_crossentropy`` keeps only the
positive-class term and its ``smooth_jaccard_loss`` scales the distance by
``smooth`` — both quirks reproduced.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-7


def binary_crossentropy(y_true, y_pred):
    clipped = np.clip(np.asarray(y_pred, dtype=np.float64), _EPS, 1 - _EPS)
    return float(-(np.log(clipped) * np.asarray(y_true, dtype=np.float64)).sum())


def _overlap_terms(y_true, y_pred):
    t = np.asarray(y_true, dtype=np.float64)
    p = np.asarray(y_pred, dtype=np.float64)
    inter = float((t * p).sum())
    return inter, float(t.sum() + p.sum())


def jaccard_coef(y_true, y_pred):
    inter, total = _overlap_terms(y_true, y_pred)
    return inter / (total + _EPS - inter)


def jaccard_loss(y_true, y_pred):
    return 1.0 - jaccard_coef(y_true, y_pred)


def smooth_jaccard_loss(y_true, y_pred, smooth: float = 100.0):
    inter, total = _overlap_terms(y_true, y_pred)
    jac = (inter + smooth) / (total - inter + smooth)
    return (1.0 - jac) * smooth


def bce_jaccard_loss(y_true, y_pred):
    return binary_crossentropy(y_true, y_pred) + jaccard_loss(y_true, y_pred)


def bce_smooth_jaccard_loss(y_true, y_pred):
    return binary_crossentropy(y_true, y_pred) + smooth_jaccard_loss(y_true, y_pred)
