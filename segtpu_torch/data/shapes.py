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
  * :func:`SHAPES` and :func:`SHAPES_DEVICE`: the registry's ``shapes`` and
    ``shapes-device`` splits; :class:`DeviceShapesSet` and
    :class:`DeviceShapesLoader` serve the latter with no host work per batch
    beyond seeding a generator.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.parallel import process_slot


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
        # on the device once: a copy from host memory per batch would make
        # the host wait for the card at every batch
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1)
        self.std = torch.as_tensor(IMAGENET_STD, device=self.device).view(1, 3, 1, 1)

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
            img = (img / 255.0 - self.mean) / self.std
        return img, mask


def _batch_seed(seed: int, epoch: int, index: int) -> int:
    """A stable 63-bit seed for batch ``index`` of ``epoch`` (blake2b, not
    the per-process salted ``hash``)."""
    digest = hashlib.blake2b(f"{seed}/{epoch}/{index}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


class DeviceShapesSet:
    """SHAPES made on the device, registered as ``shapes-device``
    (segtpu/data/shapes.py:150-205).

    No host work per batch beyond seeding a generator, so the card never
    waits on a host loader. Train samples are keyed on (seed, epoch, batch),
    fresh every epoch like the host path's; a ``fixed`` set (validation)
    ignores the epoch, so every epoch evaluates the same samples."""

    def __init__(self, n: int, patch_size: int, seed: int = 0, fixed: bool = False,
                 grayscale: bool = False):
        self.n = n
        self.patch_size = patch_size
        self.seed = seed
        self.fixed = fixed
        self.grayscale = grayscale

    def __len__(self):
        return self.n

    @property
    def num_channels(self) -> int:
        return 1 if self.grayscale else 3

    def take(self, n: int) -> "DeviceShapesSet":
        """A copy cut to ``n`` samples (the ``-s`` cap; ``Subset`` for host sets)."""
        return DeviceShapesSet(min(self.n, n), self.patch_size, seed=self.seed,
                               fixed=self.fixed, grayscale=self.grayscale)

    def loader(self, batch_size: int, device: DeviceLike = None, process_index: int = None,
               process_count: int = None) -> "DeviceShapesLoader":
        return DeviceShapesLoader(self, batch_size, device, process_index, process_count)


class DeviceShapesLoader:
    """The loader interface of :class:`~segtpu_torch.data.pipeline.DataLoader`
    (``__len__``, ``set_epoch``, iteration, ``drop_last``) over
    :class:`DeviceShapes`: yields NCHW float32 ``(x, y)`` on the device,
    which ``prefetch_to_device`` passes through. Batch ``i`` of epoch ``e``
    comes from a ``torch.Generator`` on the device seeded from (seed, e, i);
    nothing is copied from the host, so no batch waits for the card. With
    ``grayscale`` the luma is taken from the raw 0-255 RGB and then
    normalised with the grayscale ImageNet statistics, the host path's order
    (``ShapesDataset.__getitem__``).

    Multi-process (``process_index`` / ``process_count``, defaults as
    :class:`~segtpu_torch.data.pipeline.DataLoader`'s): each process makes
    the whole global batch on its device and keeps its contiguous slice, so
    the slices put together are the one-process batch bit for bit."""

    def __init__(self, spec: DeviceShapesSet, batch_size: int, device: DeviceLike = None,
                 process_index: int = None, process_count: int = None):
        self.spec = spec
        self.batch_size = batch_size
        self.epoch = 0
        self.process_index, self.process_count, self.local_batch_size = process_slot(
            batch_size, process_index, process_count)
        self.gen = DeviceShapes(spec.patch_size, normalize=not spec.grayscale, device=device)
        self.generator = torch.Generator(device=self.gen.device)
        self.gray = torch.as_tensor(GRAY_WEIGHTS, device=self.gen.device).view(1, 3, 1, 1)

    def __len__(self):
        return self.spec.n // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = 0 if self.spec.fixed else epoch

    def __iter__(self):
        for i in range(len(self)):
            self.generator.manual_seed(_batch_seed(self.spec.seed, self.epoch, i))
            x, y = self.gen.batch(self.batch_size, self.generator)
            if self.spec.grayscale:
                x = (x * self.gray).sum(1, keepdim=True)
                x = (x / 255.0 - IMAGENET_GRAY_MEAN) / IMAGENET_GRAY_STD
            if self.process_count > 1:
                lo = self.process_index * self.local_batch_size
                x, y = x[lo:lo + self.local_batch_size], y[lo:lo + self.local_batch_size]
            yield x, y


def SHAPES(patch_size: int, seed: int = 0, grayscale: bool = False):
    """``(train_ds, valid_ds, num_classes)``: 1024 train and 128 validation
    samples, 1 class (reference lib/datasets/shapes.py:62-69)."""
    return (
        ShapesDataset(1024, patch_size, seed=seed, grayscale=grayscale),
        ShapesDataset(128, patch_size, seed=seed + 1_000_000, grayscale=grayscale),
        1,
    )


def SHAPES_DEVICE(patch_size: int, seed: int = 0, grayscale: bool = False):
    """``shapes-device``: the split sizes and class count of :func:`SHAPES`,
    the samples made on the device."""
    return (
        DeviceShapesSet(1024, patch_size, seed=seed, grayscale=grayscale),
        DeviceShapesSet(128, patch_size, seed=seed + 1_000_000, fixed=True,
                        grayscale=grayscale),
        1,
    )
