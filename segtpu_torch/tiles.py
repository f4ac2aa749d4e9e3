"""Tiled inference geometry and merging (counterpart of segtpu/tiles.py;
reference lib/tiles.py).

``ImageSlicer`` cuts a large image into overlapping tiles and merges tiled
predictions back with weighted fusion. ``split``/``merge`` are the host
tile paths, as segtpu's (segtpu/tiles.py:112-180): ``split`` cuts with
NumPy; :meth:`ImageSlicer.split_batch` and :meth:`ImageSlicer.merge` run
the native tile I/O of :mod:`segtpu_torch.native` (one threaded C++ pass
each, float64 accumulation, the reference's arithmetic), and fall back to
``split`` and :meth:`ImageSlicer.merge_numpy`, their plain versions with
the same bits, only where :func:`segtpu_torch.native.available` is False;
:meth:`ImageSlicer.merge_device` merges a tile batch that lies on the device
with ``F.fold``, which sums the weighted tiles of the regular crop grid in
fp32 without leaving the device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def compute_pyramid_weight(width: int, height: int):
    """Center-weighted fusion matrix W = alpha * De / (Dc + De)
    (reference compute_patch_weight_loss, tiles.py:6-27), vectorized.

    Indexing parity: the first axis is the reference's ``i`` (over width).
    """
    xc, yc = width * 0.5, height * 0.5
    i = np.arange(width, dtype=np.float64)[:, None]
    j = np.arange(height, dtype=np.float64)[None, :]

    dc = np.sqrt((i - xc + 0.5) ** 2 + (j - yc + 0.5) ** 2)
    de_l = np.sqrt((i + 0.5) ** 2 + 0.25)
    de_r = np.sqrt((i - width + 0.5) ** 2 + 0.25)
    de_b = np.sqrt(0.25 + (j + 0.5) ** 2)
    de_t = np.sqrt(0.25 + (j - height + 0.5) ** 2)
    de = np.minimum(np.minimum(de_l, de_r), np.minimum(de_b, de_t))

    frac = de / (dc + de)
    alpha = (width * height) / frac.sum()
    w = alpha * frac
    return w, dc, de


class ImageSlicer:
    """Slice an image into tiles and merge predictions back with fusion
    (reference ImageSlicer, tiles.py:30-168 — same constructor contract).
    Crops are ``(x, y, w, h)``, y-outer row-major on a grid of ``tile_step``."""

    def __init__(self, image_shape, tile_size: int, tile_step: int = 0,
                 image_margin: int = 0, weight: str = "mean"):
        self.image_height = image_shape[0]
        self.image_width = image_shape[1]
        self.tile_size = tile_size
        self.tile_step = tile_step

        weights = {"mean": self._mean, "pyramid": self._pyramid}
        self.weight_name = weight
        self.compute_weight = weights[weight]

        if tile_step < 1 or tile_step > tile_size:
            raise ValueError(f"tile_step {tile_step} must be in [1, {tile_size}]")

        overlap = tile_size - tile_step

        self.margin_left = self.margin_right = 0
        self.margin_top = self.margin_bottom = 0

        if image_margin == 0:
            nw = max(1, math.ceil((self.image_width - overlap) / tile_step))
            nh = max(1, math.ceil((self.image_height - overlap) / tile_step))

            extra_w = self.tile_step * nw - (self.image_width - overlap)
            extra_h = self.tile_step * nh - (self.image_height - overlap)

            self.margin_left = extra_w // 2
            self.margin_right = extra_w - self.margin_left
            self.margin_top = extra_h // 2
            self.margin_bottom = extra_h - self.margin_top
        else:
            if (self.image_width - overlap + 2 * image_margin) % tile_step != 0:
                raise ValueError("image width and margin do not fit the tile grid")
            if (self.image_height - overlap + 2 * image_margin) % tile_step != 0:
                raise ValueError("image height and margin do not fit the tile grid")
            self.margin_left = self.margin_right = image_margin
            self.margin_top = self.margin_bottom = image_margin

        self.crops: List[Tuple[int, int, int, int]] = []
        for y in range(0, self.image_height + self.margin_top + self.margin_bottom
                       - tile_size + 1, tile_step):
            for x in range(0, self.image_width + self.margin_left + self.margin_right
                           - tile_size + 1, tile_step):
                self.crops.append((x, y, tile_size, tile_size))

    def pad(self, image: np.ndarray) -> np.ndarray:
        """Reflect-pad by the margins (BORDER_REFLECT101 == np.pad 'reflect')."""
        pads = [(self.margin_top, self.margin_bottom),
                (self.margin_left, self.margin_right)]
        pads += [(0, 0)] * (image.ndim - 2)
        return np.pad(image, pads, mode="reflect")

    def split(self, image: np.ndarray) -> List[np.ndarray]:
        """Cut all tiles (reference split, tiles.py:98-117)."""
        if image.shape[:2] != (self.image_height, self.image_width):
            raise ValueError(f"image of shape {image.shape} does not match the slicer's "
                             f"{(self.image_height, self.image_width)}")
        padded = self.pad(image)
        return [np.ascontiguousarray(padded[y:y + th, x:x + tw])
                for x, y, tw, th in self.crops]

    def split_batch(self, image: np.ndarray) -> np.ndarray:
        """All tiles as one ``(T, tile, tile, C)`` batch, cut by the native
        extractor in one pass from the unpadded image (virtual reflect-101
        borders, no padded copy); :meth:`split`'s tiles, stacked. uint8 or
        float32; an HW image gives C = 1."""
        from segtpu_torch import native

        if image.shape[:2] != (self.image_height, self.image_width):
            raise ValueError(f"image of shape {image.shape} does not match the slicer's "
                             f"{(self.image_height, self.image_width)}")
        if not native.available():
            tiles = np.stack(self.split(image))
            return tiles if tiles.ndim == 4 else tiles[..., None]
        return native.extract_tiles(image, [c[0] for c in self.crops],
                                    [c[1] for c in self.crops], self.tile_size,
                                    self.margin_top, self.margin_left)

    def cut_patch(self, image: np.ndarray, slice_index: int) -> np.ndarray:
        """Tile ``crops[slice_index]`` of ``image`` alone, as :meth:`split`
        cuts it (reference cut_patch, tiles.py:119-135)."""
        if image.shape[:2] != (self.image_height, self.image_width):
            raise ValueError(f"image of shape {image.shape} does not match the slicer's "
                             f"{(self.image_height, self.image_width)}")
        x, y, tw, th = self.crops[slice_index]
        return np.ascontiguousarray(self.pad(image)[y:y + th, x:x + tw])

    @property
    def target_shape(self):
        return (self.image_height + self.margin_bottom + self.margin_top,
                self.image_width + self.margin_right + self.margin_left)

    def merge(self, tiles: Sequence[np.ndarray], dtype=np.float32) -> np.ndarray:
        """Weighted-fusion merge of HWC (or HW) tiles in float64 (reference
        tiles.py:137-161), through the native merge: the products and sums
        of :meth:`merge_numpy` in the same order per pixel, so its bits."""
        from segtpu_torch import native

        if len(tiles) != len(self.crops):
            raise ValueError(f"{len(tiles)} tiles for {len(self.crops)} crops")
        if not native.available():
            return self.merge_numpy(tiles, dtype)
        stacked = np.asarray([t if t.ndim == 3 else t[..., None] for t in tiles], np.float32)
        image, norm = native.merge_tiles(
            stacked, [c[0] for c in self.crops], [c[1] for c in self.crops],
            self.compute_weight(self.tile_size), *self.target_shape)
        return self._normalise(image, norm, dtype)

    def merge_numpy(self, tiles: Sequence[np.ndarray], dtype=np.float32) -> np.ndarray:
        """:meth:`merge` in NumPy, its plain version."""
        if len(tiles) != len(self.crops):
            raise ValueError(f"{len(tiles)} tiles for {len(self.crops)} crops")

        channels = 1 if tiles[0].ndim == 2 else tiles[0].shape[2]
        target = (*self.target_shape, channels)
        w3 = np.repeat(np.asarray(self.compute_weight(self.tile_size))[:, :, None],
                       channels, axis=2)
        image = np.zeros(target, dtype=np.float64)
        norm = np.zeros(target, dtype=np.float64)
        for tile, (x, y, tw, th) in zip(tiles, self.crops):
            t = tile if tile.ndim == 3 else tile[..., None]
            image[y:y + th, x:x + tw] += t * w3
            norm[y:y + th, x:x + tw] += w3
        return self._normalise(image, norm, dtype)

    def _normalise(self, image: np.ndarray, norm: np.ndarray, dtype) -> np.ndarray:
        norm = np.clip(norm, a_min=np.finfo(norm.dtype).eps, a_max=None)
        out = np.divide(image, norm).astype(dtype)
        return out[self.margin_top:self.image_height + self.margin_top,
                   self.margin_left:self.image_width + self.margin_left]

    def merge_device(self, tiles: torch.Tensor, reduce_fn=None) -> torch.Tensor:
        """Merge a tile batch ``(T, C, t, t)`` on its own device; returns the
        ``(C, H, W)`` fp32 image. Equal to :meth:`merge` up to fp32
        accumulation.

        The crops lie on a regular grid of ``tile_step``, so ``F.fold`` with
        that stride places and sums the weighted tiles, and folds the weight
        map alone for the normalisation. ``reduce_fn(acc)`` (tile-parallel
        inference: a sum over the ranks, each holding its own tiles and zeros
        elsewhere) runs in place on the weighted sum before the division."""
        if tiles.shape[0] != len(self.crops):
            raise ValueError(f"{tiles.shape[0]} tiles for {len(self.crops)} crops")
        t, c = self.tile_size, tiles.shape[1]
        w = torch.as_tensor(self.compute_weight(t), dtype=torch.float32, device=tiles.device)
        fold = dict(output_size=self.target_shape, kernel_size=t, stride=self.tile_step)
        # fold wants (1, C*t*t, L) with block l = crop l (row-major, y outer)
        cols = (tiles.float() * w).reshape(len(self.crops), c * t * t).t()
        acc = F.fold(cols.unsqueeze(0), **fold)[0]
        if reduce_fn is not None:
            reduce_fn(acc)
        wcols = w.reshape(t * t, 1).expand(t * t, len(self.crops))
        norm = F.fold(wcols.unsqueeze(0), **fold)[0]
        out = acc / norm.clamp_min(torch.finfo(torch.float32).eps)
        return out[:, self.margin_top:self.image_height + self.margin_top,
                   self.margin_left:self.image_width + self.margin_left]

    def _mean(self, tile_size: int) -> np.ndarray:
        return np.ones((tile_size, tile_size), dtype=np.float32)

    def _pyramid(self, tile_size: int) -> np.ndarray:
        w, _, _ = compute_pyramid_weight(tile_size, tile_size)
        return w.astype(np.float64)
