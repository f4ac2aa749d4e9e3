"""Batched augmentations on the device (counterpart of segtpu/augment/device.py).

The training-time replacement of the reference's per-sample OpenCV
transforms (reference lib/augmentations.py): whole NCHW batches are
augmented on the tensor's device inside the train step, so the host only
loads and decodes. Images are float32 0-255 pixels (``channels_last`` on the
card is fine: every op indexes by dims, never by memory layout); masks are
float32 ``[N, 1, H, W]``.

Each random op is split in two:

  * a draw, ``draw_<op>(generator, n, ...)``, which takes the op's
    per-sample parameters (fire flags already applied: a sample that does
    not fire gets the identity's parameters) from an explicit
    ``torch.Generator`` on the batch's device, and
  * an apply, ``<op>(x, m, params)``, which takes them.

``random_<op>(generator, x, m, ...)`` is the two in a row. Nothing here
reads a value back to the host: draws are made on the device and every
per-sample choice is index arithmetic or a ``torch.where``.

Geometry is one affine warp: the 2x3 map from output to input pixel
coordinates (x before y, cv2's ``getRotationMatrix2D`` convention), a
reflect-101 fold of the coordinates, then a 4-tap bilinear gather. Masks
warp with the same map and are binarised after (:func:`make_binary`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD

Params = Dict[str, torch.Tensor]
Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_GRAY = (0.299, 0.587, 0.114)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def _rand(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=g, device=g.device)


def _uniform(g: torch.Generator, n: int, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * _rand(g, n)


def _fire(g: torch.Generator, n: int, prob: float) -> torch.Tensor:
    return _rand(g, n) < prob


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1)


def _where(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(flag), a, b)


def draw_fire(g: torch.Generator, n: int, prob: float = 0.5) -> Params:
    """The draw of the flips, the transpose, invert and grayscale."""
    return {"fire": _fire(g, n, prob)}


def draw_rotate90(g: torch.Generator, n: int, prob: float = 0.5) -> Params:
    """Per-sample quarter turns: ``randint(0, 5) % 4`` where the sample
    fires, else 0 (segtpu device.py:66-73: the reference's inclusive
    ``randint(0, 4)`` gives 0 twice the chance)."""
    fire = _fire(g, n, prob)
    factor = torch.randint(0, 5, (n,), generator=g, device=g.device) % 4
    return {"factor": torch.where(fire, factor, torch.zeros_like(factor))}


def draw_shift_scale_rotate(g: torch.Generator, n: int, height: int, width: int,
                            shift_limit: float = 0.0625, scale_limit: float = 0.1,
                            rotate_limit: float = 45.0, prob: float = 0.5) -> Params:
    """Angle (degrees), scale and shift (pixels) per sample
    (segtpu device.py:144-162)."""
    fire = _fire(g, n, prob)
    angle = _uniform(g, n, -rotate_limit, rotate_limit)
    scale = _uniform(g, n, 1 - scale_limit, 1 + scale_limit)
    dx = _uniform(g, n, -shift_limit, shift_limit) * width
    dy = _uniform(g, n, -shift_limit, shift_limit) * height
    zero = torch.zeros_like(angle)
    return {"angle": torch.where(fire, angle, zero), "scale": torch.where(fire, scale, zero + 1),
            "dx": torch.where(fire, dx, zero), "dy": torch.where(fire, dy, zero)}


def draw_shift(g: torch.Generator, n: int, limit: float = 4.0, prob: float = 0.5) -> Params:
    """Whole-pixel shifts per sample (segtpu device.py:180-186)."""
    fire = _fire(g, n, prob)
    dx = torch.round(_uniform(g, n, -limit, limit))
    dy = torch.round(_uniform(g, n, -limit, limit))
    zero = torch.zeros_like(dx)
    return {"dx": torch.where(fire, dx, zero), "dy": torch.where(fire, dy, zero)}


def draw_crop(g: torch.Generator, n: int, height: int, width: int, size: int) -> Params:
    """Top-left corner of each sample's crop (segtpu device.py:197-200)."""
    return {"i": torch.randint(0, height - size + 1, (n,), generator=g, device=g.device),
            "j": torch.randint(0, width - size + 1, (n,), generator=g, device=g.device)}


def draw_alpha(g: torch.Generator, n: int, low: float, high: float, prob: float = 0.5,
               identity: float = 1.0) -> Params:
    """``alpha ~ U(low, high)`` where the sample fires, else ``identity``:
    brightness and contrast (1 + limit * U(-1, 1)), saturation
    (1 + U(-limit, limit)) and the filter's blend (limit * U(0, 1), identity 0)."""
    fire = _fire(g, n, prob)
    alpha = _uniform(g, n, low, high)
    return {"alpha": torch.where(fire, alpha, torch.full_like(alpha, identity))}


def draw_shift_scale(g: torch.Generator, n: int, width: int, limit: int = 4,
                     prob: float = 0.25) -> Params:
    """The crop side and offsets of :func:`shift_scale`, as the scale ``s``
    and the shifts of its affine map (segtpu device.py:302-311)."""
    size0 = float(width)
    size1 = size0 + 2 * limit
    fire = _fire(g, n, prob)
    size = torch.round(_uniform(g, n, size0, size1))
    dx = torch.round(_rand(g, n) * (size1 - size))
    dy = torch.round(_rand(g, n) * (size1 - size))
    zero = torch.zeros_like(size)
    return {"s": torch.where(fire, size / size0, zero + 1),
            "dx": torch.where(fire, dx - limit, zero), "dy": torch.where(fire, dy - limit, zero)}


def draw_hsv_shift(g: torch.Generator, n: int, hue_shift_limit=(-10, 10),
                   sat_shift_limit=(-25, 25), val_shift_limit=(-25, 25),
                   prob: float = 0.5) -> Params:
    """Per-sample H, S and V offsets (segtpu device.py:368-375)."""
    fire = _fire(g, n, prob)
    out = {}
    for key, (low, high) in (("dh", hue_shift_limit), ("ds", sat_shift_limit),
                             ("dv", val_shift_limit)):
        v = _uniform(g, n, low, high)
        out[key] = torch.where(fire, v, torch.zeros_like(v))
    return out


# ---------------------------------------------------------------------------
# D4 geometric ops
# ---------------------------------------------------------------------------

def _both(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
          m: Optional[torch.Tensor]) -> Pair:
    return fn(x), None if m is None else fn(m)


def vertical_flip(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """Rows reversed where ``fire`` (reference aug:93-102)."""
    return _both(lambda a: _where(p["fire"], a.flip(2), a), x, m)


def horizontal_flip(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """Columns reversed where ``fire`` (reference aug:105-114)."""
    return _both(lambda a: _where(p["fire"], a.flip(3), a), x, m)


def transpose(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """H and W swapped where ``fire`` (reference aug:117-126; square images)."""
    return _both(lambda a: _where(p["fire"], a.transpose(2, 3), a), x, m)


def rotate90(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """Each sample turned by ``factor`` quarter turns counter-clockwise
    (``np.rot90``'s direction; reference aug:129-139; square images)."""
    factor = _per_sample(p["factor"])

    def rot(a):
        out = a
        for k in (1, 2, 3):
            out = torch.where(factor == k, torch.rot90(a, k, dims=(2, 3)), out)
        return out

    return _both(rot, x, m)


# ---------------------------------------------------------------------------
# Affine warp with reflect-101 border
# ---------------------------------------------------------------------------

def _reflect101(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Fold coordinates into [0, size - 1] with reflect-101 semantics."""
    period = 2.0 * (size - 1.0)
    c = torch.remainder(coord.abs(), period)
    return torch.where(c > size - 1.0, period - c, c)


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``img`` [N, C, H, W] at per-sample coordinates ``ys``/``xs`` [N, h, w]:
    reflect-101 fold, then the 4-tap gather with ``x1 = min(x0 + 1, W - 1)``
    (segtpu device.py:101-114)."""
    n, c, h, w = img.shape
    ys = _reflect101(ys, h)
    xs = _reflect101(xs, w)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0).unsqueeze(1)
    wx = (xs - x0).unsqueeze(1)
    flat = img.reshape(n, c, h * w)
    out_hw = ys.shape[1:]

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        return flat.gather(2, idx).reshape(n, c, *out_hw)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def affine_warp(img: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Warp each image of ``img`` [N, C, H, W] by its 2x3 *inverse* map
    ``matrix`` [N, 2, 3] (output -> input coordinates, x first)."""
    n, _, h, w = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    m = matrix.to(torch.float32).view(n, 2, 3, 1, 1)
    xs = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]
    ys = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]
    return _bilinear_sample(img, ys, xs)


def _ssr_inverse_matrix(angle_deg: torch.Tensor, scale: torch.Tensor, dx: torch.Tensor,
                        dy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[N, 2, 3] inverse maps of rotate(angle) and scale about the centre,
    then translate by (dx, dy) (segtpu device.py:117-130). Computed in
    float64 and rounded to fp32 once, so the card and the CPU, whose fp32
    cos and sin differ by an ulp, build the same map."""
    a = angle_deg.double() * math.pi / 180.0
    cos, sin = torch.cos(a), torch.sin(a)
    cx, cy = width * 0.5, height * 0.5
    inv_s = 1.0 / scale.double()
    dx, dy = dx.double(), dy.double()
    m00 = cos * inv_s
    m01 = sin * inv_s
    m10 = -sin * inv_s
    m11 = cos * inv_s
    tx = cx - m00 * (cx + dx) - m01 * (cy + dy)
    ty = cy - m10 * (cx + dx) - m11 * (cy + dy)
    mats = torch.stack([torch.stack([m00, m01, tx], -1), torch.stack([m10, m11, ty], -1)], -2)
    return mats.to(torch.float32)


def _warp_both(x: torch.Tensor, m: Optional[torch.Tensor], mats: torch.Tensor) -> Pair:
    return _both(lambda a: affine_warp(a, mats), x, m)


def shift_scale_rotate(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """One warp per sample by ``angle``, ``scale``, ``dx``, ``dy``
    (reference aug:224-259); the mask with the same map."""
    h, w = x.shape[2], x.shape[3]
    return _warp_both(x, m, _ssr_inverse_matrix(p["angle"], p["scale"], p["dx"], p["dy"], w, h))


def shift(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """Whole-pixel shift by ``dx``, ``dy`` with the reflect-101 border
    (reference aug:164-187)."""
    h, w = x.shape[2], x.shape[3]
    zero = torch.zeros_like(p["dx"])
    return _warp_both(x, m, _ssr_inverse_matrix(zero, zero + 1, p["dx"], p["dy"], w, h))


def random_vertical_flip(g, x, m=None, prob: float = 0.5) -> Pair:
    return vertical_flip(x, m, draw_fire(g, x.shape[0], prob))


def random_horizontal_flip(g, x, m=None, prob: float = 0.5) -> Pair:
    return horizontal_flip(x, m, draw_fire(g, x.shape[0], prob))


def random_transpose(g, x, m=None, prob: float = 0.5) -> Pair:
    return transpose(x, m, draw_fire(g, x.shape[0], prob))


def random_rotate90(g, x, m=None, prob: float = 0.5) -> Pair:
    return rotate90(x, m, draw_rotate90(g, x.shape[0], prob))


def random_shift_scale_rotate(g, x, m=None, shift_limit: float = 0.0625,
                              scale_limit: float = 0.1, rotate_limit: float = 45.0,
                              prob: float = 0.5) -> Pair:
    p = draw_shift_scale_rotate(g, x.shape[0], x.shape[2], x.shape[3], shift_limit,
                                scale_limit, rotate_limit, prob)
    return shift_scale_rotate(x, m, p)


def random_rotate(g, x, m=None, limit: float = 90.0, prob: float = 0.5) -> Pair:
    """(reference aug:142-161): SSR with no shift and no scale."""
    return random_shift_scale_rotate(g, x, m, shift_limit=0.0, scale_limit=0.0,
                                     rotate_limit=limit, prob=prob)


def random_shift(g, x, m=None, limit: float = 4.0, prob: float = 0.5) -> Pair:
    return shift(x, m, draw_shift(g, x.shape[0], limit, prob))


def crop(x: torch.Tensor, m: Optional[torch.Tensor], p: Params, size: int) -> Pair:
    """Each sample's ``size`` x ``size`` window at its (``i``, ``j``)
    (reference aug:283-344), by index arithmetic over the batch."""
    dev = x.device
    rows = (p["i"].view(-1, 1) + torch.arange(size, device=dev)).view(-1, 1, size, 1)
    cols = (p["j"].view(-1, 1) + torch.arange(size, device=dev)).view(-1, 1, 1, size)
    batch = torch.arange(x.shape[0], device=dev).view(-1, 1, 1, 1)

    def take(a):
        ch = torch.arange(a.shape[1], device=dev).view(1, -1, 1, 1)
        return a[batch, ch, rows, cols]

    return _both(take, x, m)


def random_crop(g, x, m, size: int) -> Pair:
    return crop(x, m, draw_crop(g, x.shape[0], x.shape[2], x.shape[3], size), size)


def center_crop(x: torch.Tensor, m: Optional[torch.Tensor], size: int) -> Pair:
    """(reference aug:262-280)."""
    h, w = x.shape[2], x.shape[3]
    dy, dx = (h - size) // 2, (w - size) // 2
    return _both(lambda a: a[:, :, dy:dy + size, dx:dx + size], x, m)


# ---------------------------------------------------------------------------
# Photometric (image only)
# ---------------------------------------------------------------------------

def _image_max(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(1, 2, 3), keepdim=True)


def _clip(x: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp(x, min=0), high)


def _gray(x: torch.Tensor, weights: Sequence[float] = _GRAY) -> torch.Tensor:
    """``w0 * R + w1 * G + w2 * B`` as [N, H, W]."""
    return weights[0] * x[:, 0] + weights[1] * x[:, 1] + weights[2] * x[:, 2]


def brightness(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``alpha * x`` clipped to [0, the image's max] (reference aug:380-392)."""
    return _clip(_per_sample(p["alpha"]) * x, _image_max(x))


def contrast(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Blend with 3x the mean gray, the reference's scalar (aug:395-409)."""
    alpha = _per_sample(p["alpha"])
    gray_mean = _per_sample(3.0 * _gray(x).mean(dim=(1, 2)))
    return _clip(alpha * x + (1.0 - alpha) * gray_mean, _image_max(x))


def saturation(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Blend with the per-pixel gray (reference aug:412-427)."""
    alpha = _per_sample(p["alpha"])
    return _clip(alpha * x + (1.0 - alpha) * _gray(x).unsqueeze(1), _image_max(x))


def invert(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``max - x`` where ``fire`` (reference aug:76-83)."""
    return _where(p["fire"], _image_max(x) - x, x)


def blur_filter(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``alpha * filter2D(x, ones(3, 3) / 9 * 0.2) + (1 - alpha) * x``, clipped
    to the image's max (reference aug:351-371): the 3x3 box over a
    reflect-101 pad, its nine taps summed in fp32 in row-major order (a
    convolution would run in TF32 on the card)."""
    h, w = x.shape[2], x.shape[3]
    alpha = _per_sample(p["alpha"])
    pad = F.pad(x, (1, 1, 1, 1), mode="reflect")
    taps = [pad[:, :, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    blurred = sum(taps[1:], taps[0]) * ((1.0 / 9.0) * 0.2)
    return _clip(alpha * blurred + (1.0 - alpha) * x, _image_max(x))


def random_brightness(g, x, limit: float = 0.1, prob: float = 0.5) -> torch.Tensor:
    return brightness(x, draw_alpha(g, x.shape[0], 1.0 - limit, 1.0 + limit, prob))


def random_contrast(g, x, limit: float = 0.1, prob: float = 0.5) -> torch.Tensor:
    return contrast(x, draw_alpha(g, x.shape[0], 1.0 - limit, 1.0 + limit, prob))


def random_saturation(g, x, limit: float = 0.3, prob: float = 0.5) -> torch.Tensor:
    return saturation(x, draw_alpha(g, x.shape[0], 1.0 - limit, 1.0 + limit, prob))


def random_invert(g, x, prob: float = 0.5) -> torch.Tensor:
    return invert(x, draw_fire(g, x.shape[0], prob))


def random_filter(g, x, limit: float = 0.5, prob: float = 0.5) -> torch.Tensor:
    return blur_filter(x, draw_alpha(g, x.shape[0], 0.0, limit, prob, identity=0.0))


def shift_scale(x: torch.Tensor, m: Optional[torch.Tensor], p: Params) -> Pair:
    """Reflect-pad, crop a square of side ``s * W`` and resize back
    (reference aug:190-221), as one warp:
    ``out(u, v) = in(u * s + dy, v * s + dx)``."""
    s = p["s"]
    zero = torch.zeros_like(s)
    mats = torch.stack([torch.stack([s, zero, p["dx"]], -1),
                        torch.stack([zero, s, p["dy"]], -1)], -2)
    return _warp_both(x, m, mats)


def random_shift_scale(g, x, m=None, limit: int = 4, prob: float = 0.25) -> Pair:
    return shift_scale(x, m, draw_shift_scale(g, x.shape[0], x.shape[3], limit, prob))


def _rgb_to_hsv_cv2(x: torch.Tensor):
    """RGB (0-255 float) -> cv2's 8-bit HSV: H in [0, 180), S and V in
    [0, 255], each [N, H, W]."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    one = torch.ones_like(diff)
    safe = torch.where(diff > 0, diff, one)
    s = torch.where(v > 0, diff / torch.where(v > 0, v, one) * 255.0, torch.zeros_like(v))
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff > 0, h, torch.zeros_like(h))
    h = torch.where(h < 0, h + 360.0, h) / 2.0
    return h, s, v


def _hsv_to_rgb_cv2(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    h = h * 2.0
    s = s / 255.0
    c = v * s
    hp = h / 60.0
    xcomp = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    zeros = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(hp).to(torch.int32), 6)

    def select(values):
        out = values[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(idx == k, values[k], out)
        return out

    r = select((c, xcomp, zeros, zeros, xcomp, c))
    g = select((xcomp, c, c, xcomp, zeros, zeros))
    b = select((zeros, zeros, xcomp, c, c, xcomp))
    return torch.stack([r + m, g + m, b + m], dim=1)


def hsv_shift(x: torch.Tensor, p: Params) -> torch.Tensor:
    """H, S and V moved by ``dh``, ``ds``, ``dv`` and clipped to cv2's ranges
    (reference aug:430-449)."""
    h, s, v = _rgb_to_hsv_cv2(x)
    view = lambda t: t.view(-1, 1, 1)
    h = torch.clamp(h + view(p["dh"]), 0.0, 180.0)
    s = torch.clamp(s + view(p["ds"]), 0.0, 255.0)
    v = torch.clamp(v + view(p["dv"]), 0.0, 255.0)
    return _hsv_to_rgb_cv2(h, s, v)


def random_hsv_shift(g, x, hue_shift_limit=(-10, 10), sat_shift_limit=(-25, 25),
                     val_shift_limit=(-25, 25), prob: float = 0.5) -> torch.Tensor:
    return hsv_shift(x, draw_hsv_shift(g, x.shape[0], hue_shift_limit, sat_shift_limit,
                                       val_shift_limit, prob))


def clahe(x: torch.Tensor, clip_limit: float = 2.0, grid: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of the luma
    (reference aug:463-475, cv2's CLAHE on YUV's Y; segtpu device.py:380-466).

    Per tile a 256-bin histogram (one ``index_add_`` over the batch), the
    excess over the clip limit redistributed as cv2 does in integers, the
    CDF as a LUT, and per pixel the bilinear blend of the four nearest
    tiles' LUT entries, each gathered by (sample, tile row, tile column,
    luma). H and W must be multiples of ``grid``."""
    n, _, h, w = x.shape
    th, tw = h // grid, w // grid
    tile_px = th * tw
    nbins = 256
    dev = x.device

    # the reference feeds RGB pixels into cv2's BGR2YUV, so its luma weights
    # are R/B-swapped (segtpu device.py:396-399)
    y = _gray(x, (0.114, 0.587, 0.299))
    y8 = torch.clamp(torch.round(y), 0, 255).long()

    rows = torch.arange(h, device=dev) // th
    cols = torch.arange(w, device=dev) // tw
    tile = rows.view(1, h, 1) * grid + cols.view(1, 1, w)
    sample = torch.arange(n, device=dev).view(n, 1, 1)
    flat = ((sample * (grid * grid) + tile) * nbins + y8).reshape(-1)
    hists = torch.zeros(n * grid * grid * nbins, dtype=torch.float32, device=dev)
    hists.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    hists = hists.view(n, grid * grid, nbins)

    clip_at = max(math.floor(clip_limit * tile_px / nbins), 1.0)
    clipped = torch.clamp(hists, max=clip_at)
    excess = (hists - clipped).sum(-1, keepdim=True)
    redist = torch.floor(excess / nbins)
    resid = excess - redist * nbins
    step = torch.where(resid > 0, torch.floor(nbins / torch.clamp(resid, min=1.0)),
                       torch.full_like(resid, float(nbins + 1))).to(torch.int32)
    i = torch.arange(nbins, dtype=torch.int32, device=dev)
    bonus = ((torch.remainder(i, step) == 0)
             & (torch.div(i, step, rounding_mode="floor").to(torch.float32) < resid))
    clipped = clipped + redist + bonus.to(torch.float32)
    cdf = torch.cumsum(clipped, dim=-1)
    luts = torch.clamp(torch.round(cdf * (nbins - 1.0) / tile_px), 0, 255).reshape(-1)

    yy = torch.arange(h, dtype=torch.float32, device=dev) / th - 0.5
    xx = torch.arange(w, dtype=torch.float32, device=dev) / tw - 0.5
    y0u, x0u = torch.floor(yy).long(), torch.floor(xx).long()
    wy = (yy - y0u).view(1, h, 1)
    wx = (xx - x0u).view(1, 1, w)
    y0, y1 = y0u.clamp(0, grid - 1).view(1, h, 1), (y0u + 1).clamp(0, grid - 1).view(1, h, 1)
    x0, x1 = x0u.clamp(0, grid - 1).view(1, 1, w), (x0u + 1).clamp(0, grid - 1).view(1, 1, w)
    base = sample * (grid * grid)

    def pick(ty, tx):
        return luts[((base + ty * grid + tx) * nbins + y8).reshape(-1)].view(n, h, w)

    top = pick(y0, x0) * (1 - wx) + pick(y0, x1) * wx
    bot = pick(y1, x0) * (1 - wx) + pick(y1, x1) * wx
    new_y = top * (1 - wy) + bot * wy
    # the equalised luma back, chroma kept: each channel moves by the delta
    delta = (new_y - y).unsqueeze(1)
    return torch.clamp(x + delta, 0, 255)


def grayscale(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The gray image in every channel where ``fire`` (reference aug:65-73)."""
    gray = _gray(x).unsqueeze(1).expand_as(x)
    return _where(p["fire"], gray, x)


def random_grayscale(g, x, prob: float = 0.5) -> torch.Tensor:
    return grayscale(x, draw_fire(g, x.shape[0], prob))


@functools.lru_cache(maxsize=32)
def _channel_constant(values: Tuple[float, ...], dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """``values`` as a [1, C, 1, 1] tensor on ``device``, made once, on the
    card by a copy from pinned memory that does not wait for it."""
    host = torch.tensor(values, dtype=dtype).view(1, -1, 1, 1)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def normalize(x: torch.Tensor, scale: float = 1.0 / 255.0, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """``(x * scale - mean) / std`` per channel (reference aug:452-460)."""
    mean = _channel_constant(tuple(float(v) for v in mean), x.dtype, x.device)
    std = _channel_constant(tuple(float(v) for v in std), x.dtype, x.device)
    return (x * scale - mean) / std


def make_binary(m: torch.Tensor) -> torch.Tensor:
    """(reference aug:86-90)."""
    return (m > 0).to(m.dtype)


# ---------------------------------------------------------------------------
# Pipelines: ``train(generator, x, m) -> (x, m)`` and ``eval(x, m) -> (x, m)``
# ---------------------------------------------------------------------------

def shapes_train_pipeline(g: torch.Generator, x: torch.Tensor, m: torch.Tensor) -> Pair:
    """SHAPES' train transform: normalisation only (shapes.py:48)."""
    return normalize(x), m


def eval_normalize(x: torch.Tensor, m: torch.Tensor, mean=IMAGENET_MEAN,
                   std=IMAGENET_STD) -> Pair:
    """The deterministic eval transform of a raw loader."""
    return normalize(x, mean=mean, std=std), m


def dsb2018_draw(g: torch.Generator, n: int, height: int, width: int) -> Dict[str, Params]:
    """The DSB2018 pipeline's draws, in its order (segtpu device.py:507-516)."""
    return {"rotate90": draw_rotate90(g, n), "vflip": draw_fire(g, n),
            "hflip": draw_fire(g, n),
            "ssr": draw_shift_scale_rotate(g, n, height, width, rotate_limit=15.0)}


def dsb2018_apply(x: torch.Tensor, m: torch.Tensor, p: Dict[str, Params]) -> Pair:
    """normalize -> rot90 -> vflip -> hflip -> SSR(15) -> binarise
    (reference dsb2018.py:76-84)."""
    x = normalize(x)
    x, m = rotate90(x, m, p["rotate90"])
    x, m = vertical_flip(x, m, p["vflip"])
    x, m = horizontal_flip(x, m, p["hflip"])
    x, m = shift_scale_rotate(x, m, p["ssr"])
    return x, make_binary(m)


def dsb2018_train_pipeline(g: torch.Generator, x: torch.Tensor, m: torch.Tensor) -> Pair:
    return dsb2018_apply(x, m, dsb2018_draw(g, x.shape[0], x.shape[2], x.shape[3]))


def inria_draw(g: torch.Generator, n: int, height: int, width: int,
               grayscale: bool = False) -> Dict[str, Params]:
    """The INRIA pipeline's draws, in its order (segtpu device.py:537-549)."""
    return {"grayscale": draw_fire(g, n, 1.0 if grayscale else 0.5),
            "brightness": draw_alpha(g, n, 0.9, 1.1), "contrast": draw_alpha(g, n, 0.9, 1.1),
            "vflip": draw_fire(g, n), "hflip": draw_fire(g, n),
            "ssr": draw_shift_scale_rotate(g, n, height, width, rotate_limit=15.0)}


def inria_apply(x: torch.Tensor, m: torch.Tensor, p: Dict[str, Params]) -> Pair:
    """grayscale -> brightness -> contrast -> vflip -> hflip -> SSR(15) ->
    INRIA normalisation -> binarise (reference Inria.py:48-57)."""
    x = grayscale(x, p["grayscale"])
    x = brightness(x, p["brightness"])
    x = contrast(x, p["contrast"])
    x, m = vertical_flip(x, m, p["vflip"])
    x, m = horizontal_flip(x, m, p["hflip"])
    x, m = shift_scale_rotate(x, m, p["ssr"])
    return normalize(x, mean=INRIA_MEAN, std=INRIA_STD), make_binary(m)


def inria_train_pipeline(g: torch.Generator, x: torch.Tensor, m: torch.Tensor,
                         grayscale: bool = False) -> Pair:
    return inria_apply(x, m, inria_draw(g, x.shape[0], x.shape[2], x.shape[3], grayscale))


def _binary_eval(mean, std):
    return lambda x, m: (normalize(x, mean=mean, std=std), make_binary(m))


def get_device_pipelines(dataset_name: str):
    """``(train_fn(generator, x, m), eval_fn(x, m))`` for a dataset whose
    loaders yield raw pixels, or ``None`` where the dataset has no device
    pipeline."""
    name = dataset_name.lower()
    if name == "shapes":
        return shapes_train_pipeline, eval_normalize
    if name == "dsb2018":
        return dsb2018_train_pipeline, _binary_eval(IMAGENET_MEAN, IMAGENET_STD)
    if name.startswith("inria"):
        return inria_train_pipeline, _binary_eval(INRIA_MEAN, INRIA_STD)
    return None
