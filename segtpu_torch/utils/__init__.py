"""File helpers of the port (counterpart of segtpu/utils/__init__.py;
reference lib/common.py:23-43, lib/train_utils.py:72-89). ``cv2`` is imported
only where an image is read, so hosts without OpenCV import the package."""

from __future__ import annotations

import glob
import os

import numpy as np


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
