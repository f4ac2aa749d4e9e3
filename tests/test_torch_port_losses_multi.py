"""The port's multiclass losses against segtpu's (segtpu/ops/losses.py:132-240)
on the CPU: the same seeded scores (NHWC for segtpu, NCHW for the port) and
class ids, some ignored. Values to rtol 1e-5; gradients with respect to the
scores to 1e-6 x max |g|. The largest errors seen over these cases: values
2.2e-7 relative, gradients 4.6e-7 of max |g|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.ops import losses as jax_losses
from segtpu_torch.ops import losses

N, C, H, W = 2, 4, 8, 8


def _inputs(seed, ignore_index, absent_class):
    rng = np.random.RandomState(seed)
    scores = rng.normal(0.0, 2.0, (N, H, W, C)).astype(np.float32)
    targets = rng.randint(0, C, (N, H, W))
    if absent_class:
        targets[targets == C - 1] = 0  # one class never in the target
    if ignore_index is not None:
        targets[rng.rand(N, H, W) < 0.2] = ignore_index
    return scores, targets


def _both(name, scores, targets, kwargs):
    jax_fn, fn = getattr(jax_losses, name), getattr(losses, name)

    def jax_value(s):
        return jax_fn(s, jnp.asarray(targets), **kwargs)

    want, want_g = jax.value_and_grad(jax_value)(jnp.asarray(scores))
    s = torch.from_numpy(scores.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = fn(s, torch.from_numpy(targets), **kwargs)
    got.backward()
    return (float(got.detach()), float(want), s.grad.numpy().transpose(0, 2, 3, 1),
            np.asarray(want_g))


WEIGHTS = [None, (1.0, 2.0, 0.5, 3.0)]
CASES = [
    ("focal_loss_multi", dict(ignore_index=-100)),
    ("focal_loss_multi", dict(ignore_index=-100, gamma=1.0, size_average=False)),
    ("focal_loss_multi", dict(ignore_index=255, from_logits=True)),
    ("jaccard_loss_multi", dict(ignore_index=-100)),
    ("jaccard_loss_multi", dict(ignore_index=255, class_weights=WEIGHTS[1])),
    ("jaccard_loss_multi", dict(ignore_index=255, from_logits=True, smooth=1.0)),
    ("focal_and_jaccard_loss_multi", dict(ignore_index=-1)),
    ("focal_and_jaccard_loss_multi", dict(ignore_index=-1, jaccard_weight=0.5,
                                          class_weights=WEIGHTS[1])),
    ("nll_and_jaccard_loss_multi", dict(ignore_index=-1)),
    ("nll_and_jaccard_loss_multi", dict(ignore_index=-1, jaccard_weight=2.0,
                                        class_weights=WEIGHTS[1])),
]


@pytest.mark.parametrize("absent_class", [False, True])
@pytest.mark.parametrize("with_ignored", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_multiclass_loss_matches_segtpu(case, with_ignored, absent_class):
    name, kwargs = CASES[case]
    scores, targets = _inputs(case, kwargs["ignore_index"] if with_ignored else None,
                              absent_class)
    if kwargs.get("from_logits"):
        scores = np.asarray(jax.nn.log_softmax(jnp.asarray(scores), axis=-1))
    got, want, got_g, want_g = _both(name, scores, targets, kwargs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.abs(got_g - want_g).max() <= 1e-6 * np.abs(want_g).max()


def test_jaccard_multi_unreduced_per_class():
    scores, targets = _inputs(3, -100, True)
    want = jax_losses.jaccard_loss_multi(jnp.asarray(scores), jnp.asarray(targets), reduce=False)
    got = losses.jaccard_loss_multi(torch.from_numpy(scores.transpose(0, 3, 1, 2).copy()),
                                    torch.from_numpy(targets), reduce=False)
    assert got.shape == (C,) and float(got[C - 1]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_nll_is_zero_at_ignored_pixels_and_all_ignored_is_finite():
    """Every pixel ignored: the focal mean is 0 (zeros over every pixel) and
    the NLL term divides by the clamped weight sum, as segtpu's."""
    scores = np.random.RandomState(0).normal(size=(1, 4, 4, C)).astype(np.float32)
    targets = np.full((1, 4, 4), -1)
    for name in ("focal_and_jaccard_loss_multi", "nll_and_jaccard_loss_multi"):
        got, want, got_g, want_g = _both(name, scores, targets, {})
        assert got == want == 0.0
        np.testing.assert_array_equal(got_g, want_g)


def test_multiclass_losses_stay_out_of_the_registry():
    for name in ("focal_loss_multi", "jaccard_loss_multi", "focal_and_jaccard_loss_multi",
                 "nll_and_jaccard_loss_multi"):
        with pytest.raises(ValueError):
            losses.get_loss(name)
        with pytest.raises(ValueError):
            jax_losses.get_loss(name)
