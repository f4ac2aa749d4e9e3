"""Deterministic multi-instance nuclei-style fixture generator (a copy of
segtpu/data/nuclei_fixture.py).

The DSB2018 stage-1 data cannot be fetched in this environment (zero egress),
so accuracy parity vs the torch reference is demonstrated on a *committed
generator* (not committed data): seeded, multi-instance, two-modality
microscopy-style images + binary masks, written in the exact on-disk layout
the DSB2018 loaders expect (``<dir>/images/*.png`` + ``<dir>/masks/*.png``,
reference lib/datasets/dsb2018.py:20-21,61-62).

Realism properties carried over from the real DSB2018 stage-1 data:
  * many instances per image (6-28 nuclei), elliptical, rotated, touching and
    overlapping — the mask is a non-convex union, not a single blob;
  * two imaging modalities: fluorescence (bright nuclei on a dark field) and
    brightfield (dark stained nuclei on a light field), mixed in one dataset;
  * mixed image sizes (256x256 and 320x256) so the overlap slicer produces a
    non-trivial patch grid per image;
  * per-nucleus intensity/texture variation, background gradient + sensor
    noise, soft anti-aliased instance boundaries.

Everything is driven by ``np.random.default_rng`` seeded per image — the same
(seed, index) always produces the same bytes, so tests can assert determinism
and the A/B harnesses (segtpu's tools/ab_nuclei.py, the port's
``python -m segtpu_torch.ab_nuclei``) regenerate the dataset instead of
committing image files.

    python -m segtpu_torch.data.nuclei_fixture <out_dir> [-n 48] [--seed 20260819]
"""

from __future__ import annotations

import os

import numpy as np

# (height, width) cycle — mixed sizes like the real stage-1 archive
_SIZES = ((256, 256), (256, 256), (256, 320), (256, 256), (320, 256))


def _nucleus_alpha(h: int, w: int, cy, cx, ry, rx, theta) -> np.ndarray:
    """Soft coverage map of one rotated ellipse (float32 in [0, 1])."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy -= cy
    xx -= cx
    ct, st = np.cos(theta), np.sin(theta)
    u = (ct * xx + st * yy) / rx
    v = (-st * xx + ct * yy) / ry
    d = np.sqrt(u * u + v * v)
    # ~1 inside, smooth 1.5px-wide falloff at the rim (anti-aliased edge)
    edge = min(rx, ry)
    return np.clip((1.0 - d) * edge / 1.5 + 0.5, 0.0, 1.0).astype(np.float32)


def generate_image(seed: int, index: int):
    """One (image_rgb_uint8 HxWx3, mask_uint8 HxW in {0,255}) pair."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    h, w = _SIZES[index % len(_SIZES)]
    fluorescence = bool(rng.random() < 0.6)

    # --- background -------------------------------------------------------
    if fluorescence:
        base = rng.uniform(8.0, 36.0)
        tint = np.array([1.0, rng.uniform(0.7, 1.0), rng.uniform(1.0, 1.6)])
    else:
        base = rng.uniform(185.0, 228.0)
        tint = np.array([1.0, rng.uniform(0.92, 1.0), rng.uniform(0.95, 1.05)])
    gy = rng.uniform(-0.08, 0.08)
    gx = rng.uniform(-0.08, 0.08)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    canvas = base * (1.0 + gy * (yy / h - 0.5) + gx * (xx / w - 0.5))
    canvas = canvas[..., None] * tint[None, None, :]

    # --- nuclei -----------------------------------------------------------
    n = int(rng.integers(6, 29))
    coverage = np.zeros((h, w), np.float32)
    for _ in range(n):
        cy = rng.uniform(6, h - 6)
        cx = rng.uniform(6, w - 6)
        ry = rng.uniform(5.0, 18.0)
        rx = ry * rng.uniform(0.6, 1.5)
        theta = rng.uniform(0, np.pi)
        alpha = _nucleus_alpha(h, w, cy, cx, ry, rx, theta)
        if fluorescence:
            level = rng.uniform(110.0, 235.0)
            col = level * np.array(
                [rng.uniform(0.25, 0.55), rng.uniform(0.25, 0.6), 1.0])
        else:
            level = rng.uniform(45.0, 110.0)
            col = level * np.array(
                [rng.uniform(0.9, 1.2), rng.uniform(0.5, 0.8), 1.0])
        # per-nucleus chromatin texture (low-freq speckle)
        small = rng.normal(0.0, 1.0, (h // 8 + 1, w // 8 + 1)).astype(np.float32)
        tex = 1.0 + 0.12 * np.repeat(np.repeat(small, 8, 0), 8, 1)[:h, :w]
        paint = (alpha * tex)[..., None] * col[None, None, :]
        canvas = canvas * (1.0 - alpha[..., None]) + paint
        coverage = np.maximum(coverage, alpha)

    # --- sensor noise -----------------------------------------------------
    canvas = canvas + rng.normal(0.0, rng.uniform(2.0, 7.0), canvas.shape)
    image = np.clip(canvas, 0, 255).astype(np.uint8)
    mask = np.where(coverage >= 0.5, 255, 0).astype(np.uint8)
    return image, mask


def write_fixture(out_dir: str, n_images: int = 48, seed: int = 20260819) -> str:
    """Write ``<out_dir>/images/NNN.png`` + ``<out_dir>/masks/NNN.png``.

    Returns ``out_dir``. Filenames are zero-padded so sorted order equals
    generation order.
    """
    import cv2

    img_dir = os.path.join(out_dir, "images")
    mask_dir = os.path.join(out_dir, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for i in range(n_images):
        image, mask = generate_image(seed, i)
        # stored as-is: both loaders cv2.imread the file, so the on-disk
        # channel order is shared by the torch reference and segtpu
        cv2.imwrite(os.path.join(img_dir, "%03d.png" % i), image)
        cv2.imwrite(os.path.join(mask_dir, "%03d.png" % i), mask)
    return out_dir


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("-n", "--n-images", type=int, default=48)
    p.add_argument("--seed", type=int, default=20260819)
    args = p.parse_args(argv)
    write_fixture(args.out_dir, args.n_images, args.seed)
    print("wrote", args.n_images, "image/mask pairs to", args.out_dir)


if __name__ == "__main__":
    main()
