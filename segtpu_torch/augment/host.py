"""Host-side per-sample transforms (a copy of segtpu/augment/host.py;
reference lib/augmentations.py) and the per-sample random streams of seeded
training. Probability-gated ``(img, mask)`` transforms over NumPy and
OpenCV, used by the DSB2018 and INRIA pipelines inside the threaded
``DataLoader``. Each transform draws its gate first, then its parameters,
from its ``rng`` (a ``random.Random``) or :data:`DEFAULT_RNG`. ``cv2`` is
imported by the transforms that call it, so the package imports without it.

Per-sample streams are the reproducibility contract of seeded training: the
loader binds ``Random(h(seed, epoch, dataset_index))`` around each
``__getitem__`` (:func:`bind_sample_rng`), so a sample's draws depend only on
which sample of which epoch is made, never on which loader thread made it or
how many threads the loader runs. :data:`DEFAULT_RNG` draws from the bound
stream, and from the module-global ``random`` when none is bound.
"""

from __future__ import annotations

import hashlib
import math
import numbers
import random as _random
import threading

import numpy as np

_sample_ctx = threading.local()


def derive_sample_rng(seed: int, epoch: int, index: int) -> _random.Random:
    """Stateless per-sample stream: ``Random`` keyed on (seed, epoch, index)
    by blake2b, which, unlike ``hash()``, is not salted per process."""
    digest = hashlib.blake2b(f"{seed}/{epoch}/{index}".encode(), digest_size=8).digest()
    return _random.Random(int.from_bytes(digest, "little"))


class bind_sample_rng:
    """Context manager binding the calling thread's per-sample stream, which
    :data:`DEFAULT_RNG` draws from. On exit the binding that was there
    before comes back, so a nested binding leaves the outer one in place."""

    def __init__(self, seed: int, epoch: int, index: int):
        self.rng = derive_sample_rng(seed, epoch, index)

    def __enter__(self) -> _random.Random:
        self.outer = getattr(_sample_ctx, "rng", None)
        _sample_ctx.rng = self.rng
        return self.rng

    def __exit__(self, *exc):
        _sample_ctx.rng = self.outer
        return False


class _DefaultRNG:
    """``random.Random`` facade: the bound per-sample stream, else the
    module-global ``random``."""

    @staticmethod
    def _impl():
        return getattr(_sample_ctx, "rng", None) or _random

    def random(self):
        return self._impl().random()

    def uniform(self, a, b):
        return self._impl().uniform(a, b)

    def randint(self, a, b):
        return self._impl().randint(a, b)

    def choice(self, seq):
        return self._impl().choice(seq)


DEFAULT_RNG = _DefaultRNG()


class Sequential:
    """(reference aug:10-17)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, mask=None):
        for t in self.transforms:
            x, mask = t(x, mask)
        return x, mask


class ImageOnly:
    def __init__(self, trans):
        self.trans = trans

    def __call__(self, x, mask=None):
        return self.trans(x), mask


class MaskOnly:
    def __init__(self, trans):
        self.trans = trans

    def __call__(self, x, mask):
        return x, self.trans(mask)


class OneOf:
    """Apply one randomly chosen transform with probability ``prob``
    (reference aug:20-30)."""

    def __init__(self, transforms, prob=0.5, rng=None):
        self.transforms = transforms
        self.prob = prob
        self.rng = rng or DEFAULT_RNG

    def __call__(self, x, mask=None):
        if self.rng.random() < self.prob:
            t = self.rng.choice(self.transforms)
            t.prob = 1.0
            x, mask = t(x, mask)
        return x, mask


class OneOrOther:
    """(reference aug:33-46)."""

    def __init__(self, first, second, prob=0.5, rng=None):
        self.first = first
        first.prob = 1.0
        self.second = second
        second.prob = 1.0
        self.prob = prob
        self.rng = rng or DEFAULT_RNG

    def __call__(self, x, mask=None):
        if self.rng.random() < self.prob:
            return self.first(x, mask)
        return self.second(x, mask)


class MakeBinary:
    """mask > 0 -> {0,1}, dtype preserved (reference aug:86-90)."""

    def __call__(self, x):
        return (x > 0).astype(x.dtype)


class _Gated:
    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = rng or DEFAULT_RNG

    def _fire(self):
        return self.rng.random() < self.prob


class VerticalFlip(_Gated):
    def __call__(self, img, mask=None):
        if self._fire():
            img = np.flipud(img).copy()
            if mask is not None:
                mask = np.flipud(mask).copy()
        return img, mask


class HorizontalFlip(_Gated):
    def __call__(self, img, mask=None):
        if self._fire():
            img = np.fliplr(img).copy()
            if mask is not None:
                mask = np.fliplr(mask).copy()
        return img, mask


class Transpose(_Gated):
    def __call__(self, img, mask=None):
        if self._fire():
            img = img.transpose(1, 0, 2).copy()
            if mask is not None:
                mask = mask.transpose(1, 0).copy()
        return img, mask


class RandomRotate90(_Gated):
    def __call__(self, img, mask=None):
        if self._fire():
            factor = self.rng.randint(0, 4)
            img = np.rot90(img, factor).copy()
            if mask is not None:
                mask = np.rot90(mask, factor).copy()
        return img, mask


class Rotate(_Gated):
    """warpAffine rotation, reflect-101 border (reference aug:142-161)."""

    def __init__(self, limit=90, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img, mask=None):
        import cv2

        if self._fire():
            angle = self.rng.uniform(-self.limit, self.limit)
            h, w = img.shape[:2]
            mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
            img = cv2.warpAffine(img, mat, (w, h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_REFLECT_101)
            if mask is not None:
                mask = cv2.warpAffine(mask, mat, (w, h), flags=cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_REFLECT_101)
        return img, mask


class Shift(_Gated):
    """Integer-pixel shift via reflect-padded crop (reference aug:164-187)."""

    def __init__(self, limit=4, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img, mask=None):
        import cv2

        if self._fire():
            limit = self.limit
            dx = round(self.rng.uniform(-limit, limit))
            dy = round(self.rng.uniform(-limit, limit))
            h, w = img.shape[:2]
            y1, x1 = limit + 1 + dy, limit + 1 + dx
            pad = limit + 1
            img1 = cv2.copyMakeBorder(img, pad, pad, pad, pad,
                                      borderType=cv2.BORDER_REFLECT_101)
            img = img1[y1:y1 + h, x1:x1 + w].copy()
            if mask is not None:
                m1 = cv2.copyMakeBorder(mask, pad, pad, pad, pad,
                                        borderType=cv2.BORDER_REFLECT_101)
                mask = m1[y1:y1 + h, x1:x1 + w].copy()
        return img, mask


class ShiftScale(_Gated):
    """Random crop-of-padded + resize back (reference aug:190-221, square
    inputs only)."""

    def __init__(self, limit=4, prob=0.25, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img, mask=None):
        import cv2

        if self._fire():
            limit = self.limit
            h, w = img.shape[:2]
            assert w == h
            size0 = w
            size1 = w + 2 * limit
            size = round(self.rng.uniform(size0, size1))
            dx = round(self.rng.uniform(0, size1 - size))
            dy = round(self.rng.uniform(0, size1 - size))

            def cut(arr):
                a1 = cv2.copyMakeBorder(arr, limit, limit, limit, limit,
                                        borderType=cv2.BORDER_REFLECT_101)
                c = a1[dy:dy + size, dx:dx + size]
                if size == size0:
                    return c.copy()
                return cv2.resize(c, (size0, size0), interpolation=cv2.INTER_LINEAR)

            img = cut(img)
            if mask is not None:
                mask = cut(mask)
        return img, mask


class ShiftScaleRotate(_Gated):
    """Combined perspective-warp SSR (reference aug:224-259)."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit

    def __call__(self, img, mask=None):
        import cv2

        if self._fire():
            h, w = img.shape[:2]
            angle = self.rng.uniform(-self.rotate_limit, self.rotate_limit)
            scale = self.rng.uniform(1 - self.scale_limit, 1 + self.scale_limit)
            # quirk preserved: round() of the fractional shift before scaling
            # by width means the shift is almost always 0 (aug:238-239)
            dx = round(self.rng.uniform(-self.shift_limit, self.shift_limit)) * w
            dy = round(self.rng.uniform(-self.shift_limit, self.shift_limit)) * h

            cc = math.cos(angle / 180 * math.pi) * scale
            ss = math.sin(angle / 180 * math.pi) * scale
            rot = np.array([[cc, -ss], [ss, cc]])
            box0 = np.array([[0, 0], [w, 0], [w, h], [0, h]])
            box1 = (box0 - np.array([w / 2, h / 2])) @ rot.T + np.array(
                [w / 2 + dx, h / 2 + dy])
            mat = cv2.getPerspectiveTransform(box0.astype(np.float32),
                                              box1.astype(np.float32))
            img = cv2.warpPerspective(img, mat, (w, h), flags=cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_REFLECT_101)
            if mask is not None:
                mask = cv2.warpPerspective(mask, mat, (w, h),
                                           flags=cv2.INTER_LINEAR,
                                           borderMode=cv2.BORDER_REFLECT_101)
        return img, mask


class CenterCrop:
    """(reference aug:262-280)."""

    def __init__(self, height, width=None):
        self.height = height
        self.width = width if width is not None else height

    def __call__(self, img, mask=None):
        h, w = img.shape[:2]
        dy = (h - self.height) // 2
        dx = (w - self.width) // 2
        img = img[dy:dy + self.height, dx:dx + self.width].copy()
        if mask is not None:
            mask = mask[dy:dy + self.height, dx:dx + self.width].copy()
        return img, mask


class RandomCrop:
    """(reference aug:283-344)."""

    def __init__(self, size, padding=0, rng=None):
        if isinstance(size, numbers.Number):
            self.size = (int(size), int(size))
        else:
            self.size = size
        self.padding = padding
        self.rng = rng or DEFAULT_RNG

    def __call__(self, x, mask=None):
        if self.padding > 0:
            x = np.pad(x, self.padding, "constant")
        h, w = x.shape[:2]
        th, tw = self.size
        if w == tw and h == th:
            i = j = 0
        else:
            i = self.rng.randint(0, h - th)
            j = self.rng.randint(0, w - tw)
        x = x[i:i + th, j:j + tw].copy()
        if mask is not None:
            if self.padding > 0:
                mask = np.pad(mask, self.padding, "constant")
            mask = mask[i:i + th, j:j + tw].copy()
        return x, mask


def _clip(img, dtype, maxval):
    return np.clip(img, 0, maxval).astype(dtype)


class RandomGrayscale(_Gated):
    def __call__(self, img):
        import cv2

        if self._fire():
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        return img


class RandomInvert(_Gated):
    def __call__(self, img):
        if self._fire():
            img = img.max() - img
        return img


class RandomFilter(_Gated):
    """Blur/sharpen blend (reference aug:351-370)."""

    def __init__(self, limit=0.5, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img):
        import cv2

        if self._fire():
            alpha = self.limit * self.rng.uniform(0, 1)
            kernel = np.ones((3, 3), np.float32) / 9 * 0.2
            colored = img[..., :3]
            colored = alpha * cv2.filter2D(colored, -1, kernel) + (1 - alpha) * colored
            img = img.copy()
            img[..., :3] = _clip(colored, img.dtype, np.max(img[..., :3]))
        return img


class RandomBrightness(_Gated):
    def __init__(self, limit=0.1, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img):
        if self._fire():
            alpha = 1.0 + self.limit * self.rng.uniform(-1, 1)
            img = img.copy()
            img[..., :3] = _clip(alpha * img[..., :3], img.dtype,
                                 np.max(img[..., :3]))
        return img


class RandomContrast(_Gated):
    def __init__(self, limit=0.1, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img):
        import cv2

        if self._fire():
            alpha = 1.0 + self.limit * self.rng.uniform(-1, 1)
            gray = cv2.cvtColor(img[:, :, :3], cv2.COLOR_BGR2GRAY)
            gray = (3.0 * (1.0 - alpha) / gray.size) * np.sum(gray)
            img = img.copy()
            img[:, :, :3] = _clip(alpha * img[:, :, :3] + gray, img.dtype,
                                  np.max(img[..., :3]))
        return img


class RandomSaturation(_Gated):
    def __init__(self, limit=0.3, prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.limit = limit

    def __call__(self, img):
        import cv2

        if self._fire():
            alpha = 1.0 + self.rng.uniform(-self.limit, self.limit)
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            gray = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
            img = img.copy()
            out = alpha * img[..., :3] + (1.0 - alpha) * gray
            img[..., :3] = _clip(out, img.dtype, np.max(img[..., :3]))
        return img


class RandomHueSaturationValue(_Gated):
    """(reference aug:430-450)."""

    def __init__(self, hue_shift_limit=(-10, 10), sat_shift_limit=(-25, 25),
                 val_shift_limit=(-25, 25), prob=0.5, rng=None):
        super().__init__(prob, rng)
        self.hue_shift_limit = hue_shift_limit
        self.sat_shift_limit = sat_shift_limit
        self.val_shift_limit = val_shift_limit

    def __call__(self, image):
        import cv2

        if self._fire():
            hsv = cv2.cvtColor(image, cv2.COLOR_BGR2HSV)
            h, s, v = cv2.split(hsv)
            h = cv2.add(h, self.rng.uniform(*self.hue_shift_limit))
            s = cv2.add(s, self.rng.uniform(*self.sat_shift_limit))
            v = cv2.add(v, self.rng.uniform(*self.val_shift_limit))
            image = cv2.cvtColor(cv2.merge((h, s, v)), cv2.COLOR_HSV2BGR)
        return image


class CLAHE:
    """(reference aug:463-473)."""

    def __init__(self, clipLimit=2.0, tileGridSize=(8, 8)):
        self.clipLimit = clipLimit
        self.tileGridSize = tileGridSize

    def __call__(self, im):
        import cv2

        yuv = cv2.cvtColor(im, cv2.COLOR_BGR2YUV)
        clahe = cv2.createCLAHE(clipLimit=self.clipLimit,
                                tileGridSize=self.tileGridSize)
        yuv[:, :, 0] = clahe.apply(yuv[:, :, 0])
        return cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)


class NormalizeImage:
    """scale + mean/std normalize (reference aug:452-460); defaults are the
    ImageNet statistics."""

    def __init__(self, scale=1.0 / 255.0, mean=(0.485, 0.456, 0.406),
                 std=(0.229, 0.224, 0.225)):
        self.scale = float(scale)
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)

    def __call__(self, x):
        return (x * self.scale - self.mean) / self.std
