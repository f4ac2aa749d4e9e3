"""File, parameter and image-grid helpers of the port (counterpart of
segtpu/utils/__init__.py; reference lib/common.py:15-43,
lib/train_utils.py:72-89). ``cv2`` is imported only where an image is read,
so hosts without OpenCV import the package."""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np
import torch
from torch import nn


def auto_file(filename: str, where: str = ".") -> str:
    """Recursive unique-filename search (reference lib/train_utils.py:72-89)."""
    prob = os.path.join(where, filename)
    if os.path.exists(prob) and os.path.isfile(prob):
        return filename

    files = list(glob.iglob(os.path.join(where, "**", filename), recursive=True))
    if len(files) == 0:
        raise FileNotFoundError(
            "Given file could not be found with recursive search:" + filename
        )
    if len(files) > 1:
        raise FileNotFoundError(
            "More than one file matches given filename. Please specify it explicitly"
            + filename
        )
    return files[0]


def find_in_dir(dirname: str):
    """Sorted full paths of directory entries (reference lib/common.py:23)."""
    return [os.path.join(dirname, fname) for fname in sorted(os.listdir(dirname))]


def read_rgb(fname: str) -> np.ndarray:
    """Read an image file as RGB uint8 HWC (reference lib/common.py:39-43)."""
    import cv2

    x = cv2.imread(fname, cv2.IMREAD_COLOR)
    if x is None:
        raise IOError(f"cannot read image {fname}")
    return cv2.cvtColor(x, cv2.COLOR_BGR2RGB)


def read_gray(fname: str) -> np.ndarray:
    """Read an image file as grayscale uint8 HW."""
    import cv2

    x = cv2.imread(fname, cv2.IMREAD_GRAYSCALE)
    if x is None:
        raise IOError(f"cannot read image {fname}")
    return x


def read_mask(fname: str) -> np.ndarray:
    """Read a mask file as binary {0,1} uint8 HW (reference lib/common.py:46-50)."""
    return (read_gray(fname) > 0).astype(np.uint8)


def count_parameters(model: nn.Module) -> Tuple[int, int]:
    """(total, trainable) parameter counts (reference lib/common.py:15-20),
    with segtpu's meaning: both are the full count, whatever is frozen."""
    total = sum(p.numel() for p in model.parameters())
    return total, total


def make_grid(images, nrow: int = 8, pad: int = 2, normalize: bool = True) -> np.ndarray:
    """Tile an NCHW batch (numpy array or tensor) into one HWC float32 image,
    min-max normalised over the batch: segtpu's ``make_grid`` of the same
    batch in NHWC (the TensorBoard image grids, reference
    torch_train.py:221-223)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:
        images = images[:, None]
    images = images.transpose(0, 2, 3, 1)
    if normalize:
        lo, hi = images.min(), images.max()
        if hi > lo:
            images = (images - lo) / (hi - lo)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, cl = divmod(i, ncol)
        y0 = r * (h + pad) + pad
        x0 = cl * (w + pad) + pad
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def show_landmarks_batch(data, out: str = None):
    """A batch of images and masks as two grids (reference lib/common.py:25-36;
    segtpu ``show_landmarks_batch``): ``data`` is ``(x, y)``, NCHW tensors
    or arrays. Saves to ``out`` on the Agg backend when given, else shows
    the figure. Returns the figure."""
    import matplotlib
    if out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y = data
    f, (ax1, ax2) = plt.subplots(2, 1)
    ax1.imshow(np.squeeze(make_grid(x)))
    ax2.imshow(np.squeeze(make_grid(y)))
    plt.title("Batch from dataloader")
    if out:
        f.savefig(out, dpi=120)
        plt.close(f)
    else:
        plt.show()
    return f
