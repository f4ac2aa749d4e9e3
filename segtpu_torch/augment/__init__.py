"""D4 test-time augmentation and padding (counterpart of
segtpu/augment/__init__.py; reference lib/augmentations.py:476-538).

The batched TTA works on NCHW tensors (rotations over dims (2, 3), the
horizontal flip over dim 3); the list forms ``tta_d4_aug``/``tta_d4_deaug``,
``pad_to_multiple`` and ``unpad`` work on host HWC arrays. The training-time
augmentations are in :mod:`segtpu_torch.augment.host` (per sample, on the
host) and :mod:`segtpu_torch.augment.device` (batched, on the device).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tta_d4_aug_batch", "tta_d4_deaug_batch", "tta_d4_aug", "tta_d4_deaug",
           "pad_to_multiple", "unpad"]


def _rot(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.rot90(x, k, dims=(2, 3))


def tta_d4_aug_batch(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N*8, C, H, W): each sample expanded to its 8 D4-group
    transforms in the reference's order (aug:476-491):
    [id, rot90, rot180, rot270, fliplr, fliplr.rot90, fliplr.rot180,
    fliplr.rot270]; sample i occupies rows [8i, 8i+8)."""
    views = [x, _rot(x, 1), _rot(x, 2), _rot(x, 3)]
    views += [v.flip(3) for v in views]
    stacked = torch.stack(views, dim=1)  # (N, 8, C, H, W)
    return stacked.reshape(-1, *x.shape[1:])


def tta_d4_deaug_batch(x: torch.Tensor) -> torch.Tensor:
    """(N*8, C, H, W) -> (N, C, H, W): invert each D4 transform and average
    groups of 8 (reference aug:494-511)."""
    if x.shape[0] % 8 != 0:
        raise ValueError(f"TTA batch of {x.shape[0]} is not a multiple of 8")
    g = x.reshape(x.shape[0] // 8, 8, *x.shape[1:])
    inv = [
        g[:, 0],
        _rot(g[:, 1], -1),
        _rot(g[:, 2], -2),
        _rot(g[:, 3], -3),
        g[:, 4].flip(3),
        _rot(g[:, 5].flip(3), -1),
        _rot(g[:, 6].flip(3), -2),
        _rot(g[:, 7].flip(3), -3),
    ]
    return sum(inv) * (1.0 / 8.0)


def tta_d4_aug(images):
    """List of HWC arrays -> the list of each one's 8 D4 transforms, in the
    order of :func:`tta_d4_aug_batch` (reference tta_d4_aug, aug:476-491)."""
    res = []
    for image in images:
        views = [image, np.rot90(image, 1), np.rot90(image, 2), np.rot90(image, 3)]
        res.extend(views + [np.fliplr(v) for v in views])
    return res


def tta_d4_deaug(image_list):
    """Inverse of :func:`tta_d4_aug`: each group of 8 transformed back and
    averaged (reference tta_d4_deaug, aug:494-511)."""
    if len(image_list) % 8 != 0:
        raise ValueError(f"TTA list of {len(image_list)} is not a multiple of 8")
    res = []
    for i in range(0, len(image_list), 8):
        g = image_list[i:i + 8]
        res.append((g[0] + np.rot90(g[1], -1) + np.rot90(g[2], -2) + np.rot90(g[3], -3)
                    + np.fliplr(g[4]) + np.rot90(np.fliplr(g[5]), -1)
                    + np.rot90(np.fliplr(g[6]), -2) + np.rot90(np.fliplr(g[7]), -3))
                   * (1.0 / 8.0))
    return res


def pad_to_multiple(image: np.ndarray, pad_size: int):
    """Pad H/W up to a multiple of pad_size with border replicate
    (reference pad, aug:513-533). Returns (padded, (top, btm, left, right))."""
    rows, cols = image.shape[:2]
    pad_rows = rows % pad_size
    pad_cols = cols % pad_size
    if pad_rows == 0 and pad_cols == 0:
        return image, (0, 0, 0, 0)
    pad_rows = pad_size - pad_rows
    pad_cols = pad_size - pad_cols
    top = pad_rows // 2
    btm = pad_rows - top
    left = pad_cols // 2
    right = pad_cols - left
    pads = [(top, btm), (left, right)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pads, mode="edge"), (top, btm, left, right)


def unpad(image: np.ndarray, pad):
    """Inverse of :func:`pad_to_multiple` (reference unpad, aug:535-538)."""
    top, btm, left, right = pad
    rows, cols = image.shape[:2]
    return image[top:rows - btm, left:cols - right]
