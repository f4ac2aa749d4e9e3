"""SHAPES synthetic dataset (counterpart of segtpu/data/shapes.py:26-147;
reference lib/datasets/shapes.py:10-69).

A random filled ellipse on a random dark background plus salt noise, the
zero-data smoke vehicle of the whole pipeline.

  * :func:`gen_random_image` and :class:`ShapesDataset`: host NumPy, copied
    from segtpu, so a seed gives the same arrays bit for bit (HWC image,
    HW1 mask, as segtpu's).
  * :class:`DeviceShapes`: batches made on the device from an explicit
    ``torch.Generator``, NCHW. Same distribution as segtpu's ``DeviceShapes``,
    not the same bits (``jax.random`` and torch's generators differ).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from segtpu_torch.device import DeviceLike, resolve_device


def gen_random_image(patch_size: int, rng: np.random.RandomState):
    """One (image uint8 HWC, mask uint8 HW) sample, reference sampling ranges."""
    img = np.zeros((patch_size, patch_size, 3), dtype=np.uint8)
    mask = np.zeros((patch_size, patch_size), dtype=np.uint8)

    dark = rng.randint(0, 101, size=3)
    img[:, :] = dark

    light = np.array([rng.randint(d + 1, 256) for d in dark], dtype=np.uint8)
    cx = rng.randint(0, patch_size + 1)
    cy = rng.randint(0, patch_size + 1)
    r1 = rng.randint(10, 57)
    r2 = rng.randint(10, 57)

    yy, xx = np.mgrid[0:patch_size, 0:patch_size]
    inside = ((xx - cx) / r1) ** 2 + ((yy - cy) / r2) ** 2 <= 1.0
    img[inside] = light
    mask[inside] = 1

    density = rng.uniform(0, 0.1)
    salt = rng.rand(patch_size, patch_size) < density
    img[salt] = rng.randint(0, 256, size=(int(salt.sum()), 3))
    return img, mask


# ImageNet statistics, the reference's NormalizeImage defaults
# (lib/augmentations.py:452-460), applied to SHAPES (lib/datasets/shapes.py:48).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# Grayscale variants: BT.601 luma weights; channel-mean ImageNet statistics.
GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], dtype=np.float32)
IMAGENET_GRAY_MEAN = float(IMAGENET_MEAN.mean())
IMAGENET_GRAY_STD = float(IMAGENET_STD.mean())


class ShapesDataset:
    """Map-style dataset: index -> (image float32 HWC, mask HW1).

    Images are scaled 1/255 then ImageNet mean/std normalised. Sample ``i``
    of epoch ``e`` is keyed by ``seed + e * steps + i``, so shuffling and
    resume reproduce exactly. :func:`to_nchw` turns a batch of samples into
    the port's NCHW tensors."""

    def __init__(self, steps: int, patch_size: int, seed: int = 0,
                 normalize: bool = True, grayscale: bool = False):
        self.steps = steps
        self.patch_size = patch_size
        self.seed = seed
        self.normalize = normalize
        self.grayscale = grayscale
        self.epoch = 0

    def __len__(self):
        return self.steps

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.RandomState(self.seed + self.epoch * self.steps + i)
        img, mask = gen_random_image(self.patch_size, rng)
        x = img.astype(np.float32)
        if self.grayscale:
            x = (x @ GRAY_WEIGHTS)[..., None]
            if self.normalize:
                x = (x / 255.0 - IMAGENET_GRAY_MEAN) / IMAGENET_GRAY_STD
        elif self.normalize:
            x = (x / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        y = mask.astype(np.float32)[..., None]
        return x, y


def to_nchw(samples) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack (HWC image, HW1 mask) samples into NCHW float32 CPU tensors."""
    x = np.stack([s[0] for s in samples]).transpose(0, 3, 1, 2)
    y = np.stack([s[1] for s in samples]).transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(np.ascontiguousarray(y))


class DeviceShapes:
    """Batched SHAPES made on the device: ``batch(batch_size, generator)``
    returns NCHW float32 ``(x [B, 3, P, P], y [B, 1, P, P])``.

    Per sample, as segtpu's ``DeviceShapes._gen_one``: background ``dark``
    uniform in 0..100 per channel; ``light = dark + 1 + floor(U * (255 - dark))``;
    centre uniform in 0..P, radii uniform in 10..56; salt density U(0, 0.1)
    with uniform 0..255 noise; ImageNet normalisation."""

    def __init__(self, patch_size: int, normalize: bool = True, device: DeviceLike = None):
        self.patch_size = patch_size
        self.normalize = normalize
        self.device = resolve_device(device)

    def batch(self, batch_size: int, generator: torch.Generator):
        p, b, dev = self.patch_size, batch_size, self.device

        def randint(low, high, shape):
            return torch.randint(low, high, shape, generator=generator, device=dev)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=dev)

        dark = randint(0, 101, (b, 3, 1, 1)).float()
        light = dark + 1 + torch.floor(uniform((b, 3, 1, 1)) * (255 - dark))
        cx = randint(0, p + 1, (b, 1, 1, 1)).float()
        cy = randint(0, p + 1, (b, 1, 1, 1)).float()
        r1 = randint(10, 57, (b, 1, 1, 1)).float()
        r2 = randint(10, 57, (b, 1, 1, 1)).float()

        yy = torch.arange(p, dtype=torch.float32, device=dev).view(1, 1, p, 1)
        xx = torch.arange(p, dtype=torch.float32, device=dev).view(1, 1, 1, p)
        inside = ((xx - cx) / r1) ** 2 + ((yy - cy) / r2) ** 2 <= 1.0
        img = torch.where(inside, light, dark)

        density = uniform((b, 1, 1, 1)) * 0.1
        salt = uniform((b, 1, p, p)) < density
        noise = randint(0, 256, (b, 3, p, p)).float()
        img = torch.where(salt, noise, img)

        mask = inside.float()
        if self.normalize:
            mean = torch.as_tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
            std = torch.as_tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
            img = (img / 255.0 - mean) / std
        return img, mask
