"""Host-side transforms (copies of the combinators and ``NormalizeImage`` of
segtpu/augment/host.py; reference lib/augmentations.py) and the per-sample
random streams of seeded training. NumPy and the standard library only.

Per-sample streams are the reproducibility contract of seeded training: the
loader binds ``Random(h(seed, epoch, dataset_index))`` around each
``__getitem__`` (:func:`bind_sample_rng`), so a sample's draws depend only on
which sample of which epoch is made, never on which loader thread made it or
how many threads the loader runs. :data:`DEFAULT_RNG` draws from the bound
stream, and from the module-global ``random`` when none is bound.
"""

from __future__ import annotations

import hashlib
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
