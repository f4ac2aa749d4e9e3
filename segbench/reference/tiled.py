"""Tiled inference, plain (reference inria_submit.py:237-257 and
lib/tiles.py): the image is normalised, reflect-padded (border reflect-101)
so that tiles of ``patch`` at step ``patch // 2`` cover it with equal
margins, each tile is predicted (with D4 TTA, the mean of the eight
transforms' probabilities mapped back), the tiles are merged with the
pyramid weights, the margins are cut off and the result is thresholded.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def geometry(height: int, width: int, patch: int):
    """``(margins (top, bottom, left, right), crops [(y, x)])`` of a
    ``height`` x ``width`` image at ``patch``, step ``patch // 2`` (lib/tiles.py:30-96)."""
    step = patch // 2
    overlap = patch - step

    def axis(size: int):
        n = max(1, math.ceil((size - overlap) / step))
        extra = step * n - (size - overlap)
        return extra // 2, extra - extra // 2, n

    top, bottom, nh = axis(height)
    left, right, nw = axis(width)
    crops = [(iy * step, ix * step) for iy in range(nh) for ix in range(nw)]
    return (top, bottom, left, right), crops


def pyramid_weight(patch: int) -> np.ndarray:
    """``alpha * De / (Dc + De)``: the distance to the tile's centre against
    the distance to its nearest edge, scaled to mean 1 (lib/tiles.py:6-27)."""
    i = np.arange(patch, dtype=np.float64)[:, None]
    j = np.arange(patch, dtype=np.float64)[None, :]
    c = patch * 0.5
    dc = np.sqrt((i - c + 0.5) ** 2 + (j - c + 0.5) ** 2)
    edges = (np.sqrt((i + 0.5) ** 2 + 0.25), np.sqrt((i - patch + 0.5) ** 2 + 0.25),
             np.sqrt(0.25 + (j + 0.5) ** 2), np.sqrt(0.25 + (j - patch + 0.5) ** 2))
    de = np.minimum(np.minimum(edges[0], edges[1]), np.minimum(edges[2], edges[3]))
    frac = de / (dc + de)
    return frac * (patch * patch / frac.sum())


def d4_predict(prob: Callable[[torch.Tensor], torch.Tensor], tiles: torch.Tensor) -> torch.Tensor:
    """The mean over the eight rotations and mirror images of ``tiles``
    (N, C, p, p) of ``prob``'s output mapped back to the tile's frame."""
    views = [torch.rot90(tiles, k, (2, 3)) for k in range(4)]
    views += [v.flip(3) for v in views]
    out = prob(torch.cat(views)).split(tiles.shape[0])
    back = [torch.rot90(out[k], -k, (2, 3)) for k in range(4)]
    back += [torch.rot90(out[4 + k].flip(3), -k, (2, 3)) for k in range(4)]
    return sum(back) / 8.0


def probabilities(prob: Callable[[torch.Tensor], torch.Tensor], image: np.ndarray,
                  normalize: dict, patch: int, tta: bool, tiles_per_call: int,
                  device: torch.device) -> torch.Tensor:
    """The merged ``(H, W)`` fp32 probabilities of the HWC uint8 ``image``,
    ``prob`` mapping NCHW fp32 images to NCHW probabilities; the tiles go
    ``tiles_per_call`` at a time."""
    h, w = image.shape[:2]
    (top, bottom, left, right), crops = geometry(h, w, patch)
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(2, 0, 1).float()
    mean = torch.tensor(normalize["mean"], device=device).view(-1, 1, 1)
    std = torch.tensor(normalize["std"], device=device).view(-1, 1, 1)
    x = (x * normalize["scale"] - mean) / std
    x = F.pad(x[None], (left, right, top, bottom), mode="reflect")[0]
    weight = torch.tensor(pyramid_weight(patch), dtype=torch.float32, device=device)
    acc = torch.zeros(x.shape[1:], device=device)
    norm = torch.zeros(x.shape[1:], device=device)
    for i in range(0, len(crops), tiles_per_call):
        block = crops[i:i + tiles_per_call]
        tiles = torch.stack([x[:, y:y + patch, c:c + patch] for y, c in block])
        p = d4_predict(prob, tiles) if tta else prob(tiles)
        for (y, c), t in zip(block, p[:, 0]):
            acc[y:y + patch, c:c + patch] += t * weight
            norm[y:y + patch, c:c + patch] += weight
    out = acc / norm.clamp_min(torch.finfo(torch.float32).eps)
    return out[top:top + h, left:left + w]


def tiles_per_image(height: int, width: int, patch: int) -> int:
    return len(geometry(height, width, patch)[1])

