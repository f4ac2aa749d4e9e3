"""Host-side transforms needed by inference (copies of the combinators and
``NormalizeImage`` of segtpu/augment/host.py; reference lib/augmentations.py).
NumPy only."""

from __future__ import annotations

import numpy as np


class Sequential:
    """(reference aug:10-17)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, mask=None):
        for t in self.transforms:
            x, mask = t(x, mask)
        return x, mask


class ImageOnly:
    def __init__(self, trans):
        self.trans = trans

    def __call__(self, x, mask=None):
        return self.trans(x), mask


class MaskOnly:
    def __init__(self, trans):
        self.trans = trans

    def __call__(self, x, mask):
        return x, self.trans(mask)


class NormalizeImage:
    """scale + mean/std normalize (reference aug:452-460); defaults are the
    ImageNet statistics."""

    def __init__(self, scale=1.0 / 255.0, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225)):
        self.scale = float(scale)
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)

    def __call__(self, x):
        return (x * self.scale - self.mean) / self.std
