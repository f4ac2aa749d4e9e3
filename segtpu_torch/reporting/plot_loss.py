"""Loss-shape plots from the NumPy loss mirrors (counterpart of
segtpu/reporting/plot_loss.py; reference plot_loss.py:9-40).

Sweeps the prediction's confidence from 1.0 down to 0.0 on an all-ones
target and plots each loss's shape to ``<out>/<loss>.png``:

    python -m segtpu_torch.reporting.plot_loss --out loss_shapes/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from segtpu_torch.ops import numpy_losses
from segtpu_torch.reporting.plot import _pyplot

LOSS_FUNCTIONS = (numpy_losses.binary_crossentropy, numpy_losses.jaccard_loss,
                  numpy_losses.smooth_jaccard_loss, numpy_losses.bce_smooth_jaccard_loss)


def loss_shape(loss_fn, size: int = 224, steps: int = 1000):
    """``loss_fn`` at confidence 1, then 1 - i / steps for i in 0..steps-1."""
    y_true = np.ones((size, size), dtype=np.float32)
    y_pred = y_true.copy()
    losses = [loss_fn(y_true, y_pred)]
    for pred_val in range(0, steps):
        y_pred[...] = 1 - pred_val / steps
        losses.append(loss_fn(y_true, y_pred))
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="loss_shapes")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    plt = _pyplot()
    for loss_fn in LOSS_FUNCTIONS:
        losses = loss_shape(loss_fn)
        plt.figure()
        plt.title(loss_fn.__name__)
        plt.plot(losses)
        plt.ylabel("Loss value")
        plt.xlabel("Wrong pixels")
        plt.tight_layout()
        path = os.path.join(args.out, f"{loss_fn.__name__}.png")
        plt.savefig(path, dpi=120)
        plt.close()
        print("wrote", path)


if __name__ == "__main__":
    main()
