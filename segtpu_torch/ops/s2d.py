"""Space-to-depth (s2d) execution (counterpart of segtpu/ops/s2d.py).

A feature map ``[N, C, H, W]`` in s2d form is ``[N, 4C, H/2, W/2]``: each
2x2 block of pixels becomes one pixel of 4C channels in the order
``(dy, dx, c)``, sub-position-major, segtpu's order (``F.pixel_unshuffle``
orders them ``(c, dy, dx)`` and is not used). A stride-1 odd-k conv in
normal space equals a conv in s2d space with a kernel expanded from the
dense one by gathers (:func:`s2d_kernel`), so the dense kernel stays the
trained parameter and the ``state_dict`` is the same in both forms.
BatchNorm statistics are combined over the 4 sub-positions of each true
channel (``parts`` in :mod:`segtpu_torch.ops.abn`), so the math is that of
normal space up to the order of float additions.

segtpu runs s2d to fill the TPU's 128-lane channel tiles at the 32- and
64-channel full-resolution levels. The H100 pads no channels; here the
expanded 3x3 kernels carry 4x the MACs of normal space.

Weight layouts are torch's: a conv weight is OIHW ``[O, C, k, k]`` and a
transposed conv's ``[I, O, k, k]``. The tables are segtpu's, applied to
the HWIO / ``[k, k, O, I]`` views of these weights, and the expanded kernels
come back in OIHW.

The tensors are made in channels_last memory: :func:`s2d` and :func:`d2s`
work on the NHWC view, as segtpu does, and copy once.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def s2d(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W] -> [N, 4C, H/2, W/2]``, channel order ``(dy, dx, c)``."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return y.permute(0, 3, 1, 2)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`: ``[N, 4C, H, W] -> [N, C, 2H, 2W]``."""
    n, cc, h, w = x.shape
    c = cc // 4
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _axis_tables(k: int):
    """Static (block-tap index, validity) tables for one spatial axis
    (segtpu ``_axis_tables``): for output sub-position ``d_out`` and kernel
    tap ``a`` (SAME padding ``p = k // 2``), the input row ``2B + d_out + a -
    p`` of output block B lies in block ``B + u`` at sub-position ``d_in``
    with ``a = 2u + d_in - d_out + p``. Returns ``A[u, d_in, d_out]`` (the
    clipped tap) and its validity ``V`` over the smallest block-tap window."""
    p = k // 2
    lo = -((p + 1) // 2)
    hi = (k - 1 + 1 - p) // 2
    us = list(range(lo, hi + 1))
    A = np.zeros((len(us), 2, 2), np.int64)
    V = np.zeros((len(us), 2, 2), bool)
    for i, u in enumerate(us):
        for d_in in range(2):
            for d_out in range(2):
                a = 2 * u + d_in - d_out + p
                V[i, d_in, d_out] = 0 <= a < k
                A[i, d_in, d_out] = np.clip(a, 0, k - 1)
    return A, V


def s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Expand a dense stride-1 SAME conv weight ``[O, C, k, k]`` (k odd) to
    the s2d-space weight ``[4O, 4C, U, U]`` with ``conv(s2d(x), w', padding
    U // 2) == s2d(conv(x, w, padding k // 2))``. Gathers and a mask, so it
    is differentiable in the dense weight."""
    A, V = _axis_tables(weight.shape[2])
    u = A.shape[0]
    k = weight.permute(2, 3, 1, 0)  # HWIO [k, k, C, O]
    ia = torch.as_tensor(A, device=weight.device)
    # [U, 2(d_in), 2(d_out), U, 2(dx_in), 2(dx_out), C, O]
    kp = k[ia[:, :, :, None, None, None], ia[None, None, None, :, :, :]]
    mask = V[:, :, :, None, None, None] & V[None, None, None, :, :, :]
    kp = kp * torch.as_tensor(mask, dtype=weight.dtype, device=weight.device)[..., None, None]
    c, o = k.shape[2], k.shape[3]
    # -> [U, U, (dy_in, dx_in, C), (dy_out, dx_out, O)] -> OIHW
    kp = kp.permute(0, 3, 1, 4, 6, 2, 5, 7).reshape(u, u, 4 * c, 4 * o)
    return kp.permute(3, 2, 0, 1)


def s2d_tile_channels(x: torch.Tensor, reps: int = 4) -> torch.Tensor:
    """Per-true-channel data on all 4 sub-positions: the s2d form of 2x
    nearest upsampling (``[N, C, H, W] -> [N, 4C, H, W]``)."""
    return x.repeat(1, reps, 1, 1)


def s2d_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel concat in s2d space, interleaved so that the result is
    ``s2d(cat([A, B], 1))``: each sub-position group holds ``[a_c, b_c]``.
    The models concatenate block-wise instead and fold the order into the
    consuming conv's kernel (:func:`blocked_perm`)."""
    n, _, h, w = a.shape
    ca, cb = a.shape[1] // 4, b.shape[1] // 4
    out = torch.cat([a.reshape(n, 4, ca, h, w), b.reshape(n, 4, cb, h, w)], 2)
    return out.reshape(n, 4 * (ca + cb), h, w)


def expand_kernel_parts(weight: torch.Tensor, parts: Sequence[Tuple[str, int]]) -> torch.Tensor:
    """Expand a dense conv weight ``[O, C, k, k]`` for an input that is a
    block-wise concat of parts in the dense channel order:

      ``("s2d", c)``   an s2d tensor of c true channels (4c channels);
      ``("fold", c)``  a normal-space tensor at the s2d grid's resolution
                       whose nearest 2x upsampling feeds the conv: the 4
                       expanded taps of its channel are summed into one.

    Returns the ``[4O, sum(4c | c), U, U]`` weight (segtpu
    ``expand_kernel_parts``)."""
    kp = s2d_kernel(weight)  # [4O, 4Cd, U, U], d_in-major canonical order
    cd = weight.shape[1]
    cols, off = [], 0
    for kind, c in parts:
        idx = np.arange(c) + off
        if kind == "s2d":
            gather = (np.arange(4)[:, None] * cd + idx[None, :]).reshape(-1)
            cols.append(kp[:, torch.as_tensor(gather, device=weight.device)])
        elif kind == "fold":
            cols.append(sum(kp[:, d * cd + off: d * cd + off + c] for d in range(4)))
        else:
            raise ValueError(f"unknown part kind {kind!r}")
        off += c
    if off != cd:
        raise ValueError(f"parts {parts} cover {off} of the weight's {cd} input channels")
    return torch.cat(cols, 1)


@functools.lru_cache(maxsize=None)
def _deconv_tables():
    A = np.zeros((3, 2), np.int64)
    V = np.zeros((3, 2), bool)
    for ui, u in enumerate((-1, 0, 1)):
        for d in range(2):
            a = d + 1 - 2 * u
            V[ui, d] = 0 <= a < 4
            A[ui, d] = np.clip(a, 0, 3)
    return A, V


def deconv_s2d_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Expand a transposed conv weight ``[I, O, 4, 4]`` (stride 2, padding
    1: TernausNet's decoder deconv) into the stride-1 3x3 weight
    ``[4O, I, 3, 3]`` that gives the s2d form of the deconv's output from its
    half-resolution input (segtpu ``deconv_s2d_kernel``): torch's
    ``out[2b + d] = sum_u x[b + u] * K[d + 1 - 2u]``, u in {-1, 0, 1}."""
    if weight.shape[2] != 4 or weight.shape[3] != 4:
        raise ValueError(f"deconv_s2d_kernel takes a 4x4 kernel, got {tuple(weight.shape)}")
    A, V = _deconv_tables()
    k = weight.permute(2, 3, 1, 0)  # [4, 4, O, I]
    ia = torch.as_tensor(A, device=weight.device)
    # [ty, tx, dy, dx, O, I]
    kp = k[ia[:, None, :, None], ia[None, :, None, :]]
    mask = V[:, None, :, None] & V[None, :, None, :]
    kp = kp * torch.as_tensor(mask, dtype=weight.dtype, device=weight.device)[..., None, None]
    o, i = k.shape[2], k.shape[3]
    kp = kp.permute(0, 1, 5, 2, 3, 4).reshape(3, 3, i, 4 * o)  # HWIO, out (dy, dx, o)
    return kp.permute(3, 2, 0, 1)


@functools.lru_cache(maxsize=None)
def blocked_perm(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The input-channel permutation that maps a block-wise concat of s2d
    tensors (``[4*C_0 | 4*C_1 | ...]``, each sub-position-major) onto the
    canonical s2d order of the dense concat: ``w[:, blocked_perm(sizes)]``
    makes an expanded weight read the block-wise concat."""
    sizes = tuple(sizes)
    total = sum(sizes)
    perm = []
    for p, cp in enumerate(sizes):
        base = sum(sizes[:p])
        for d in range(4):
            perm.extend(d * total + base + c for c in range(cp))
    return tuple(perm)


def d2s_parts(x: torch.Tensor, parts: Sequence[int]) -> torch.Tensor:
    """:func:`d2s` of a block-wise concat of s2d tensors of ``parts`` true
    channels each, concatenated in dense order."""
    outs, off = [], 0
    for cp in parts:
        outs.append(d2s(x[:, off: off + 4 * cp]))
        off += 4 * cp
    return torch.cat(outs, 1)


def _first_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # ``where`` routes the whole gradient to the branch it takes: the first
    # of equal values, as torch's max pooling does (``maximum`` splits ties)
    return torch.where(a >= b, a, b)


def s2d_max_pool_exit(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pooling of the normal-space tensor, from its s2d
    form: the pooling window is the s2d block, so this is a max over the 4
    sub-positions, and the output is in normal space at half resolution.
    The gradient goes to the first maximal position in row-major window
    order, as ``F.max_pool2d``'s."""
    c = x.shape[1] // 4
    x00, x01, x10, x11 = (x[:, i * c:(i + 1) * c] for i in range(4))
    return _first_max(_first_max(x00, x01), _first_max(x10, x11))


def s2d_max_pool3_exit(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 padding-1 max pooling (the ResNeXt stem's) of the
    normal-space tensor, from its s2d form: tap a of output o reads
    sub-position ``(a + 1) % 2`` of block ``o - (a == 0)``, so the 9 taps
    are channel slices, 3 of them shifted one block with -inf at the
    leading edge. The output is in normal space at half resolution; the
    gradient goes to the first maximal tap in row-major order, as
    ``F.max_pool2d``'s."""
    n, cc, hb, wb = x.shape
    c = cc // 4
    v = x.reshape(n, 2, 2, c, hb, wb)

    def shift(t: torch.Tensor, dim: int) -> torch.Tensor:
        edge = torch.full_like(t.narrow(dim, 0, 1), float("-inf"))
        return torch.cat([edge, t.narrow(dim, 0, t.shape[dim] - 1)], dim)

    sel = {0: (True, 1), 1: (False, 0), 2: (False, 1)}
    best = None
    for ar in range(3):
        shift_r, dy = sel[ar]
        for ac in range(3):
            shift_c, dx = sel[ac]
            t = v[:, dy, dx]
            if shift_r:
                t = shift(t, 2)
            if shift_c:
                t = shift(t, 3)
            best = t if best is None else _first_max(best, t)
    return best
