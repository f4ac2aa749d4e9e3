"""segtpu_torch.augment.device against segtpu.augment.device on the CPU.

The same seeded 0-255 pixels (4 x 64 x 64 x 3, numpy) and the same
parameters go through both: for a jax key, the helpers of
``torch_port_util`` replay segtpu's splits and draws and hand the values to
the port's apply. Tolerances (fp32):

  * bit-equal: flips, rot90, transpose, crops, invert, grayscale,
    normalize, make_binary, CLAHE (at most 1 grey level on 0.1% of pixels
    is allowed, none is seen) and the affine warp fed segtpu's own matrix;
  * the warp ops end to end (SSR, rotate, shift, shift_scale) to 1e-2 on
    the 0-255 scale: segtpu builds the SSR map in fp32 (XLA's cos and sin),
    the port in float64 rounded once (so that the card and the CPU agree);
    the maps differ by up to 4 ulp of their terms, and on random pixels (up
    to 255 grey levels per pixel) a coordinate an ulp off at 64 px moves a
    value by up to 4.2e-3 (the worst of 60 keys);
  * masks after a warp: binarised, a mismatch only where segtpu's warped
    value lies within 1e-3 of the threshold;
  * brightness, contrast, saturation, filter 1e-4; HSV 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.augment import device as J
from segtpu_torch.augment import device as P

import torch_port_util as U

N, H, W = 4, 64, 64
KEYS = (0, 1, 2)
WARP_ATOL = 1e-2
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (N, H, W, 3)).astype(np.float32)
    m = (rng.rand(N, H, W, 1) > 0.5).astype(np.float32)
    return x, m, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), \
        torch.from_numpy(m.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _max_err(got, want):
    return float(np.abs(_nhwc(got) - np.asarray(want)).max())


EXACT_GEOMETRIC = {
    "vflip": (J.random_vertical_flip, P.vertical_flip, lambda k: U.replay_fire(k, N)),
    "hflip": (J.random_horizontal_flip, P.horizontal_flip, lambda k: U.replay_fire(k, N)),
    "transpose": (J.random_transpose, P.transpose, lambda k: U.replay_fire(k, N)),
    "rotate90": (J.random_rotate90, P.rotate90, lambda k: U.replay_rotate90(k, N)),
}


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("op", sorted(EXACT_GEOMETRIC))
def test_d4_ops_bit_equal(batch, op, seed):
    x, m, xt, mt = batch
    jax_fn, apply, replay = EXACT_GEOMETRIC[op]
    key = jax.random.PRNGKey(seed)
    want_x, want_m = jax_fn(key, jnp.asarray(x), jnp.asarray(m))
    got_x, got_m = apply(xt, mt, replay(key))
    np.testing.assert_array_equal(_nhwc(got_x), np.asarray(want_x))
    np.testing.assert_array_equal(_nhwc(got_m), np.asarray(want_m))
    assert apply(xt, None, replay(key))[1] is None


@pytest.mark.parametrize("seed", KEYS)
def test_crops_bit_equal(batch, seed):
    x, m, xt, mt = batch
    key = jax.random.PRNGKey(seed)
    want = J.random_crop(key, jnp.asarray(x), jnp.asarray(m), 40)
    got = P.crop(xt, mt, U.replay_crop(key, N, H, W, 40), 40)
    for g, w in zip(got, want):
        assert g.shape == (N, w.shape[3], 40, 40)
        np.testing.assert_array_equal(_nhwc(g), np.asarray(w))
    for g, w in zip(P.center_crop(xt, mt, 41), J.center_crop(jnp.asarray(x), jnp.asarray(m), 41)):
        np.testing.assert_array_equal(_nhwc(g), np.asarray(w))


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("op", ["invert", "grayscale"])
def test_invert_and_grayscale_bit_equal(batch, op, seed):
    x, _, xt, _ = batch
    key = jax.random.PRNGKey(seed)
    jax_fn, apply = {"invert": (J.random_invert, P.invert),
                     "grayscale": (J.random_grayscale, P.grayscale)}[op]
    np.testing.assert_array_equal(_nhwc(apply(xt, U.replay_fire(key, N))),
                                  np.asarray(jax_fn(key, jnp.asarray(x))))


def test_normalize_and_make_binary_bit_equal(batch):
    x, m, xt, mt = batch
    np.testing.assert_array_equal(_nhwc(P.normalize(xt)), np.asarray(J.normalize(jnp.asarray(x))))
    mean, std = (0.1, 0.2, 0.3), (3.0, 2.0, 1.0)
    np.testing.assert_array_equal(_nhwc(P.normalize(xt, mean=mean, std=std)),
                                  np.asarray(J.normalize(jnp.asarray(x), mean=mean, std=std)))
    soft = m * 0.7 - 0.2
    np.testing.assert_array_equal(
        _nhwc(P.make_binary(torch.from_numpy(soft.transpose(0, 3, 1, 2).copy()))),
        np.asarray(J.make_binary(jnp.asarray(soft))))


WARPS = {
    "shift_scale_rotate": (lambda k, x, m: J.shift_scale_rotate(k, x, m, prob=1.0),
                           P.shift_scale_rotate,
                           lambda k: U.replay_shift_scale_rotate(k, N, H, W, prob=1.0)),
    "rotate": (lambda k, x, m: J.random_rotate(k, x, m, prob=1.0), P.shift_scale_rotate,
               lambda k: U.replay_shift_scale_rotate(k, N, H, W, shift_limit=0.0,
                                                     scale_limit=0.0, rotate_limit=90.0,
                                                     prob=1.0)),
    "shift": (lambda k, x, m: J.random_shift(k, x, m, prob=1.0), P.shift,
              lambda k: U.replay_shift(k, N, prob=1.0)),
    "shift_scale": (lambda k, x, m: J.shift_scale(k, x, m, prob=1.0), P.shift_scale,
                    lambda k: U.replay_shift_scale(k, N, W, prob=1.0)),
}


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("op", sorted(WARPS))
def test_warps_match(batch, op, seed):
    x, m, xt, mt = batch
    jax_fn, apply, replay = WARPS[op]
    key = jax.random.PRNGKey(seed)
    want_x, want_m = jax_fn(key, jnp.asarray(x), jnp.asarray(m))
    got_x, got_m = apply(xt, mt, replay(key))
    assert _max_err(got_x, want_x) <= WARP_ATOL
    assert _max_err(got_m, want_m) <= WARP_ATOL / 255
    # binarised: a mismatch only where segtpu's value is at the threshold
    want_m = np.asarray(want_m)
    differ = _nhwc(P.make_binary(got_m)) != np.asarray(J.make_binary(want_m))
    assert not np.any(differ & (np.abs(want_m) > 1e-3))


@pytest.mark.parametrize("seed", KEYS)
def test_affine_warp_bit_equal_given_segtpus_matrices(batch, seed):
    """The gather and blend repeat segtpu's arithmetic exactly: fed segtpu's
    matrices, the warp gives segtpu's bits."""
    x, _, xt, _ = batch
    p = U.replay_shift_scale_rotate(jax.random.PRNGKey(seed), N, H, W, prob=1.0)
    mats = jax.vmap(lambda a, s, tx, ty: J._ssr_inverse_matrix(a, s, tx, ty, W, H))(
        *(jnp.asarray(p[k].numpy()) for k in ("angle", "scale", "dx", "dy")))
    want = jax.vmap(J.affine_warp)(jnp.asarray(x), mats)
    got = P.affine_warp(xt, torch.from_numpy(np.array(mats)))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    # the port's map is the exact one rounded to fp32; segtpu's, built in
    # fp32, is within 4 ulp of its terms' size (1 for the linear part, the
    # image's side for the translation)
    ours = P._ssr_inverse_matrix(p["angle"], p["scale"], p["dx"], p["dy"], W, H).numpy()
    a = np.deg2rad(p["angle"].numpy().astype(np.float64))
    inv_s = 1.0 / p["scale"].numpy().astype(np.float64)
    px, py = W * 0.5 + p["dx"].numpy(), H * 0.5 + p["dy"].numpy()
    lin = [np.cos(a) * inv_s, np.sin(a) * inv_s, -np.sin(a) * inv_s, np.cos(a) * inv_s]
    exact = np.stack([np.stack([lin[0], lin[1], W * 0.5 - lin[0] * px - lin[1] * py], -1),
                      np.stack([lin[2], lin[3], H * 0.5 - lin[2] * px - lin[3] * py], -1)], -2)
    np.testing.assert_allclose(ours, exact, rtol=0, atol=np.spacing(np.float32(W)))
    assert np.all(np.abs(ours - np.asarray(mats))
                  <= 4 * np.spacing(np.array([1.0, 1.0, W], np.float32)))


PHOTOMETRIC = {"brightness": (J.random_brightness, P.brightness, 0.1),
               "contrast": (J.random_contrast, P.contrast, 0.1),
               "saturation": (J.random_saturation, P.saturation, 0.3),
               "filter": (J.random_filter, P.blur_filter, 0.5)}


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("op", sorted(PHOTOMETRIC))
def test_photometric_ops_match(batch, op, seed):
    x, _, xt, _ = batch
    jax_fn, apply, limit = PHOTOMETRIC[op]
    key = jax.random.PRNGKey(seed)
    want = jax_fn(key, jnp.asarray(x), limit, prob=1.0)
    got = apply(xt, U.replay_alpha(key, N, op, limit, prob=1.0))
    assert _max_err(got, want) <= 1e-4


@pytest.mark.parametrize("seed", KEYS)
def test_hsv_shift_matches(batch, seed):
    x, _, xt, _ = batch
    key = jax.random.PRNGKey(seed)
    want = J.random_hsv_shift(key, jnp.asarray(x), prob=1.0)
    got = P.hsv_shift(xt, U.replay_hsv_shift(key, N, prob=1.0))
    assert _max_err(got, want) <= 1e-3


@pytest.mark.parametrize("clip_limit,grid", [(2.0, 8), (4.0, 4)])
def test_clahe_matches(batch, clip_limit, grid):
    x, _, xt, _ = batch
    want = np.asarray(J.clahe(jnp.asarray(x), clip_limit=clip_limit, grid=grid))
    err = np.abs(_nhwc(P.clahe(xt, clip_limit=clip_limit, grid=grid)) - want)
    assert err.max() <= 1.0 and (err > 1e-3).mean() <= 1e-3


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("dataset", ["shapes", "dsb2018", "inria", "inria-gray"])
def test_pipelines_match_for_a_replayed_key(batch, dataset, seed):
    """Each pipeline with segtpu's draws for one key: exact where only exact
    ops run (shapes), else the warp's gate on the 0-255 scale (the image
    error times the normalisation's 255 * std) and the mask rule."""
    x, m, xt, mt = batch
    key = jax.random.PRNGKey(seed)
    if dataset == "shapes":
        want_x, want_m = J.shapes_train_pipeline(key, jnp.asarray(x), jnp.asarray(m))
        got_x, got_m = P.shapes_train_pipeline(None, xt, mt)
        np.testing.assert_array_equal(_nhwc(got_x), np.asarray(want_x))
        np.testing.assert_array_equal(_nhwc(got_m), np.asarray(want_m))
        return
    if dataset == "dsb2018":
        want_x, want_m = J.dsb2018_train_pipeline(key, jnp.asarray(x), jnp.asarray(m))
        got_x, got_m = P.dsb2018_apply(xt, mt, U.replay_dsb2018(key, N, H, W))
        std = np.asarray(P.IMAGENET_STD)
        # segtpu's mask before binarisation: the same steps without the last
        k = jax.random.split(key, 4)
        xm, mm = J.random_rotate90(k[0], jnp.asarray(x), jnp.asarray(m))
        xm, mm = J.random_vertical_flip(k[1], xm, mm)
        xm, mm = J.random_horizontal_flip(k[2], xm, mm)
        soft = np.asarray(J.shift_scale_rotate(k[3], xm, mm, rotate_limit=15.0)[1])
    else:
        gray = dataset == "inria-gray"
        want_x, want_m = J.inria_train_pipeline(key, jnp.asarray(x), jnp.asarray(m),
                                                grayscale=gray)
        got_x, got_m = P.inria_apply(xt, mt, U.replay_inria(key, N, H, W, grayscale=gray))
        std = np.asarray(P.INRIA_STD)
        k = jax.random.split(key, 6)
        mm = J.random_vertical_flip(k[3], jnp.asarray(x), jnp.asarray(m))[1]
        mm = J.random_horizontal_flip(k[4], jnp.asarray(x), mm)[1]
        soft = np.asarray(J.shift_scale_rotate(k[5], jnp.asarray(x), mm, rotate_limit=15.0)[1])
    err = np.abs(_nhwc(got_x) - np.asarray(want_x)) * (255.0 * std)
    assert err.max() <= WARP_ATOL
    differ = _nhwc(got_m) != np.asarray(want_m)
    assert not np.any(differ & (np.abs(soft) > 1e-3))


def test_random_ops_are_their_draw_then_apply(batch):
    """``random_<op>(g, ...)`` draws from ``g`` and applies: the same
    generator state gives the same result through draw + apply."""
    _, _, xt, mt = batch
    cases = [
        (lambda g: P.random_vertical_flip(g, xt, mt),
         lambda g: P.vertical_flip(xt, mt, P.draw_fire(g, N))),
        (lambda g: P.random_rotate90(g, xt, mt),
         lambda g: P.rotate90(xt, mt, P.draw_rotate90(g, N))),
        (lambda g: P.random_shift_scale_rotate(g, xt, mt),
         lambda g: P.shift_scale_rotate(xt, mt, P.draw_shift_scale_rotate(g, N, H, W))),
        (lambda g: P.random_crop(g, xt, mt, 32),
         lambda g: P.crop(xt, mt, P.draw_crop(g, N, H, W, 32), 32)),
        (lambda g: (P.random_filter(g, xt),),
         lambda g: (P.blur_filter(xt, P.draw_alpha(g, N, 0.0, 0.5, identity=0.0)),)),
        (lambda g: (P.random_hsv_shift(g, xt),),
         lambda g: (P.hsv_shift(xt, P.draw_hsv_shift(g, N)),)),
        (lambda g: P.random_shift_scale(g, xt, mt),
         lambda g: P.shift_scale(xt, mt, P.draw_shift_scale(g, N, W))),
        (lambda g: P.dsb2018_train_pipeline(g, xt, mt),
         lambda g: P.dsb2018_apply(xt, mt, P.dsb2018_draw(g, N, H, W))),
        (lambda g: P.inria_train_pipeline(g, xt, mt),
         lambda g: P.inria_apply(xt, mt, P.inria_draw(g, N, H, W))),
    ]
    for composed, split in cases:
        a = composed(torch.Generator().manual_seed(5))
        b = split(torch.Generator().manual_seed(5))
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_draws_fire_and_identity(batch):
    """prob 0 leaves every op the identity; rot90's factor takes 0 twice as
    often as each other turn (``randint(0, 5) % 4``)."""
    _, m, xt, mt = batch
    g = torch.Generator().manual_seed(0)
    for got in (P.random_vertical_flip(g, xt, mt, prob=0.0),
                P.random_rotate90(g, xt, mt, prob=0.0),
                P.random_shift_scale_rotate(g, xt, mt, prob=0.0),
                P.random_shift(g, xt, mt, prob=0.0), P.random_shift_scale(g, xt, mt, prob=0.0)):
        assert torch.equal(got[0], xt) and torch.equal(got[1], mt)
    for got in (P.random_brightness(g, xt, prob=0.0), P.random_contrast(g, xt, prob=0.0),
                P.random_invert(g, xt, prob=0.0), P.random_grayscale(g, xt, prob=0.0)):
        assert torch.equal(got, xt)
    factor = P.draw_rotate90(torch.Generator().manual_seed(1), 20000, prob=1.0)["factor"]
    share = torch.bincount(factor, minlength=4).double() / factor.numel()
    assert abs(share[0] - 0.4) < 0.02 and all(abs(s - 0.2) < 0.02 for s in share[1:])
    p = P.draw_shift_scale_rotate(torch.Generator().manual_seed(2), 1000, H, W, rotate_limit=15.0)
    assert p["angle"].abs().max() <= 15.0 and p["dx"].abs().max() <= 0.0625 * W
    assert ((p["angle"] == 0) == (p["scale"] == 1)).all()
    crop = P.draw_crop(torch.Generator().manual_seed(3), 1000, H, W, 40)
    assert crop["i"].min() >= 0 and crop["i"].max() == H - 40


def test_same_seed_same_augmentation(batch):
    _, _, xt, mt = batch
    a = P.dsb2018_train_pipeline(torch.Generator().manual_seed(9), xt, mt)
    b = P.dsb2018_train_pipeline(torch.Generator().manual_seed(9), xt, mt)
    c = P.dsb2018_train_pipeline(torch.Generator().manual_seed(10), xt, mt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_channels_last_input_gives_the_same_values(batch):
    _, _, xt, mt = batch
    p = U.replay_dsb2018(jax.random.PRNGKey(0), N, H, W)
    want = P.dsb2018_apply(xt, mt, p)
    got = P.dsb2018_apply(xt.contiguous(memory_format=torch.channels_last),
                          mt.contiguous(memory_format=torch.channels_last), p)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    np.testing.assert_array_equal(P.clahe(xt.contiguous(memory_format=torch.channels_last)),
                                  P.clahe(xt))


def test_get_device_pipelines():
    for name in ("shapes", "dsb2018", "inria", "inria-small", "inria-512", "Shapes"):
        assert J.get_device_pipelines(name) is not None and P.get_device_pipelines(name) is not None
    for name in ("shapes-device", "dsb2018-stage1", "cityscapes"):
        assert J.get_device_pipelines(name) is None and P.get_device_pipelines(name) is None
    train, evaluate = P.get_device_pipelines("dsb2018")
    x = torch.full((1, 3, 8, 8), 255.0)
    m = torch.full((1, 1, 8, 8), 255.0)
    ex, em = evaluate(x, m)
    assert torch.equal(em, torch.ones_like(m))
    np.testing.assert_allclose(ex[0, :, 0, 0].numpy(),
                               (1.0 - np.asarray(P.IMAGENET_MEAN)) / np.asarray(P.IMAGENET_STD),
                               rtol=1e-6)
