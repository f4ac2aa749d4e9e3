"""Dataset building blocks (counterpart of segtpu/data/common.py; reference
lib/common.py:53-173).

All datasets yield ``(image float32 HWC, mask float32 HW1)`` numpy arrays,
as segtpu's do: the port's ``DataLoader`` stacks them into NHWC batches and
``prefetch_to_device`` views those as NCHW on the device.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Callable, Optional, Sequence

import numpy as np

from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.utils import read_mask, read_rgb


def _to_xy(image, mask):
    x = np.ascontiguousarray(image, dtype=np.float32)
    if x.ndim == 2:
        x = x[..., None]
    if mask is None:
        return x
    m = np.ascontiguousarray(mask, dtype=np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return x, m[..., None]


class InMemoryDataset:
    """ndarray lists -> samples; mask-optional for inference
    (reference lib/common.py:53-79)."""

    def __init__(self, images: Sequence[np.ndarray],
                 masks: Optional[Sequence[np.ndarray]], transform=None):
        self.images = images
        self.masks = masks
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        i = self.images[index].copy()
        m = self.masks[index].copy() if self.masks is not None else None
        if self.transform is not None:
            i, m = self.transform(i, m)
        return _to_xy(i, m)


class ImageMaskDataset:
    """Filename pairs + loader fns, optional load-in-RAM
    (reference lib/common.py:82-113)."""

    def __init__(self, image_filenames, target_filenames,
                 image_loader: Callable, target_loader: Callable,
                 transform=None, load_in_ram: bool = False):
        if len(image_filenames) != len(target_filenames):
            raise ValueError(
                "Number of images does not corresponds to number of targets")
        if load_in_ram:
            self.images = [image_loader(f) for f in image_filenames]
            self.targets = [target_loader(f) for f in target_filenames]
            self.image_loader = lambda x: x
            self.target_loader = lambda x: x
        else:
            self.images = list(image_filenames)
            self.targets = list(target_filenames)
            self.image_loader = image_loader
            self.target_loader = target_loader
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        image = self.image_loader(self.images[index])
        mask = self.target_loader(self.targets[index])
        if self.transform is not None:
            image, mask = self.transform(image, mask)
        return _to_xy(image, mask)


class TiledImageDataset:
    """One huge image -> lazily cut tiles (reference lib/common.py:116-147).

    Each index cuts tile ``slicer.crops[i]``, re-reading from disk unless
    ``keep_in_mem``.
    """

    def __init__(self, image_fname: str, mask_fname: str, tile_size: int,
                 tile_step: Optional[int] = None, target_shape=None,
                 transform=None, keep_in_mem: bool = False,
                 image_loader=None, target_loader=None):
        self.image_loader = image_loader or read_rgb
        self.target_loader = target_loader or read_mask
        self.image_fname = image_fname
        self.mask_fname = mask_fname
        self.transform = transform
        self.keep_in_mem = keep_in_mem
        self._image = None
        self._mask = None

        if target_shape is None:
            target_shape = self.image_loader(image_fname).shape
        self.slicer = ImageSlicer(target_shape, tile_size,
                                  tile_step or tile_size)

    def _load(self):
        image = self._image
        mask = self._mask
        if image is None:
            image = self.image_loader(self.image_fname)
            mask = self.target_loader(self.mask_fname)
            if self.keep_in_mem:
                self._image, self._mask = image, mask
        return image, mask

    def __len__(self):
        return len(self.slicer.crops)

    def __getitem__(self, index):
        image, mask = self._load()
        i = self.slicer.cut_patch(image, index)
        m = self.slicer.cut_patch(mask, index)
        if self.transform is not None:
            i, m = self.transform(i, m)
        return _to_xy(i, m)


class ConcatDataset:
    """Concatenation of map-style datasets (torch ConcatDataset equivalent,
    used at reference lib/common.py:170)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)

    def __len__(self):
        return self.cumulative[-1] if self.cumulative else 0

    def __getitem__(self, index):
        ds_idx = bisect_right(self.cumulative, index)
        prev = self.cumulative[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][index - prev]


def TiledImagesDataset(image_filenames, mask_filenames, tile_size,
                       target_shape=(5000, 5000), transform=None,
                       keep_in_mem: bool = False):
    """ConcatDataset over per-image tile datasets
    (reference lib/common.py:150-173)."""
    datasets = [
        TiledImageDataset(img, msk, tile_size, target_shape=target_shape,
                          transform=transform, keep_in_mem=keep_in_mem)
        for img, msk in zip(image_filenames, mask_filenames)
    ]
    return ConcatDataset(datasets)
