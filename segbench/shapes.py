"""The SHAPES batches of the training cells, made on the device from the
run's seed: a copy of the arithmetic of segtpu_torch's ``DeviceShapes``
(reference lib/datasets/shapes.py:10-69), kept here so that the program
receives only the inputs and cannot change them.

Per sample: background ``dark`` uniform in 0..100 per channel; ``light =
dark + 1 + floor(U * (255 - dark))``; an ellipse with centre uniform in
0..P and radii uniform in 10..56; salt density U(0, 0.1) with uniform 0..255
noise; ImageNet normalisation. The mask is the ellipse.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from segbench.harness import derive

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def batch(batch_size: int, patch: int, gen: torch.Generator,
          device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One NCHW float32 batch ``(x [B, 3, P, P], y [B, 1, P, P])``."""
    b, p = batch_size, patch

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=device)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=device)

    dark = randint(0, 101, (b, 3, 1, 1)).float()
    light = dark + 1 + torch.floor(uniform((b, 3, 1, 1)) * (255 - dark))
    cx = randint(0, p + 1, (b, 1, 1, 1)).float()
    cy = randint(0, p + 1, (b, 1, 1, 1)).float()
    r1 = randint(10, 57, (b, 1, 1, 1)).float()
    r2 = randint(10, 57, (b, 1, 1, 1)).float()
    yy = torch.arange(p, dtype=torch.float32, device=device).view(1, 1, p, 1)
    xx = torch.arange(p, dtype=torch.float32, device=device).view(1, 1, 1, p)
    inside = ((xx - cx) / r1) ** 2 + ((yy - cy) / r2) ** 2 <= 1.0
    img = torch.where(inside, light, dark)
    density = uniform((b, 1, 1, 1)) * 0.1
    salt = uniform((b, 1, p, p)) < density
    img = torch.where(salt, randint(0, 256, (b, 3, p, p)).float(), img)
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    return (img / 255.0 - mean) / std, inside.float()


def pool(n: int, batch_size: int, patch: int, seed: int,
         device: torch.device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``n`` batches from one generator seeded from ``seed``: every row
    differs."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "shapes"))
    return [batch(batch_size, patch, gen, device) for _ in range(n)]
