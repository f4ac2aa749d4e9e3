"""segtpu_torch's serving slice against segtpu's: D4 TTA, padding, tile
geometry and merging, then tiled prediction, the stream and the submit CLI
end to end with one LinkNet34 carried across. NHWC arrays on the segtpu side,
NCHW tensors on the port's; fp32 on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segtpu import augment as jax_augment
from segtpu import inference as jax_inference
from segtpu import tiles as jax_tiles
from segtpu.augment import host as jax_aug

from segtpu_torch import augment, inference, tiles
from segtpu_torch.augment import host as aug
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.train.checkpoint import save_snapshot
from segtpu_torch.train.state import make_predict_step

from torch_port_util import jax_linknet34, jax_predict_fn, port_linknet34
from torch_port_util import tmp_path  # noqa: F401  (removed after use)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def test_tta_d4_aug_and_deaug_match_segtpu():
    x = np.random.RandomState(0).rand(2, 6, 6, 3).astype(np.float32)
    aug_jax = np.asarray(jax_augment.tta_d4_aug_batch(jnp.asarray(x)))
    aug_port = augment.tta_d4_aug_batch(_nchw(x))
    np.testing.assert_array_equal(_nhwc(aug_port), aug_jax)
    y = np.random.RandomState(1).rand(16, 6, 6, 2).astype(np.float32)
    np.testing.assert_allclose(_nhwc(augment.tta_d4_deaug_batch(_nchw(y))),
                               np.asarray(jax_augment.tta_d4_deaug_batch(jnp.asarray(y))),
                               atol=1e-6)
    np.testing.assert_allclose(augment.tta_d4_deaug_batch(aug_port).numpy(), _nchw(x).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(50, 70, 3), (64, 64), (33, 95, 1)])
def test_pad_to_multiple_and_unpad_match_segtpu(shape):
    image = np.random.RandomState(2).rand(*shape).astype(np.float32)
    got, pads = augment.pad_to_multiple(image, 32)
    want, want_pads = jax_augment.pad_to_multiple(image, 32)
    assert pads == want_pads
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(augment.unpad(got, pads), image)


@pytest.mark.parametrize("shape,tile,step", [
    ((5000, 5000), 512, 256), ((150, 130), 64, 32), ((96, 96), 64, 64), ((100, 77), 63, 31),
])
def test_image_slicer_geometry_matches_segtpu(shape, tile, step):
    ours = tiles.ImageSlicer(shape, tile, step, weight="pyramid")
    theirs = jax_tiles.ImageSlicer(shape, tile, step, weight="pyramid")
    assert ours.crops == theirs.crops
    assert (ours.margin_top, ours.margin_bottom, ours.margin_left, ours.margin_right) == \
        (theirs.margin_top, theirs.margin_bottom, theirs.margin_left, theirs.margin_right)
    assert ours.target_shape == theirs.target_shape


def test_pyramid_weight_matches_segtpu():
    for a, b in zip(tiles.compute_pyramid_weight(64, 64), jax_tiles.compute_pyramid_weight(64, 64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tile,step,weight", [(64, 32, "pyramid"), (63, 31, "pyramid"),
                                              (64, 32, "mean")])
def test_split_and_merges_match_segtpu(tile, step, weight):
    rng = np.random.RandomState(4)
    image = rng.rand(100, 77, 2).astype(np.float32)
    ours = tiles.ImageSlicer(image.shape, tile, step, weight=weight)
    theirs = jax_tiles.ImageSlicer(image.shape, tile, step, weight=weight)
    split = ours.split(image)
    for a, b in zip(split, theirs.split(image)):
        np.testing.assert_array_equal(a, b)
    preds = [rng.rand(tile, tile, 2).astype(np.float32) for _ in split]
    np.testing.assert_allclose(ours.merge(preds), theirs.merge(preds), atol=1e-6)
    stacked = np.stack(preds)
    got = ours.merge_device(_nchw(stacked)).numpy()
    want = np.asarray(theirs.merge_device(jnp.asarray(stacked)))
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), want, atol=1e-5)
    # the identity: merging the image's own tiles gives the image back
    np.testing.assert_allclose(np.moveaxis(ours.merge_device(_nchw(np.stack(split))).numpy(), 0, -1),
                               image, atol=1e-5)


@pytest.fixture(scope="module")
def linknet():
    module, params, stats = jax_linknet34(seed=1)
    return module, params, stats, port_linknet34(params, stats)


def _inria():
    return (aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))]),
            jax_aug.Sequential([jax_aug.ImageOnly(jax_aug.NormalizeImage(mean=INRIA_MEAN,
                                                                          std=INRIA_STD))]))


def test_predict_tiled_linknet34_matches_segtpu(linknet):
    module, params, stats, model = linknet
    image = np.random.RandomState(5).randint(0, 256, (150, 130, 3)).astype(np.uint8)
    ours_t, theirs_t = _inria()
    kw = dict(patch_size=64, batch_size=16, tta=True)
    got = inference.predict_tiled(image, make_predict_step(model), ours_t, device="cpu", **kw)
    want = jax_inference.predict_tiled(image, jax_predict_fn(module, params, stats), theirs_t, **kw)
    assert got.shape == (150, 130) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("tta", [True, False])
def test_predict_full_matches_segtpu(tta):
    """A position-dependent predictor (channel mean plus a ramp over rows), so
    that a wrong TTA inverse or padding shows."""
    image = np.random.RandomState(6).randint(0, 256, (40, 56, 3)).astype(np.uint8)
    ours_t, theirs_t = _inria()

    def ours(x):
        ramp = torch.arange(x.shape[2], dtype=torch.float32).view(1, 1, -1, 1) / 100
        return x.mean(1, keepdim=True) + ramp

    def theirs(x):
        ramp = jnp.arange(x.shape[1], dtype=jnp.float32).reshape(1, -1, 1, 1) / 100
        return jnp.mean(x, axis=-1, keepdims=True) + ramp

    got = inference.predict_full(image, ours, ours_t, tta=tta, device="cpu")
    want = jax_inference.predict_full(image, theirs, theirs_t, tta=tta)
    assert got.shape == (40, 56)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_predict_tiled_stream_matches_per_image(linknet):
    """Masks in input order, each equal to predict_tiled's; a load error in
    the producer thread is raised in the caller."""
    model = linknet[3]
    fn = make_predict_step(model)
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (70, 90, 3)).astype(np.uint8),
              rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)]
    # the threshold sits at the model's median so that the masks are not constant
    probs = inference.predict_tiled(images[0], fn, patch_size=32, batch_size=16, device="cpu")
    threshold = float(np.median(probs))
    kw = dict(patch_size=32, batch_size=16, threshold=threshold, device="cpu")
    got = list(inference.predict_tiled_stream(
        [(f"im{i}", (lambda im=im: im)) for i, im in enumerate(images)], fn, depth=1, **kw))
    assert [k for k, _ in got] == ["im0", "im1"]
    for (_, mask), im in zip(got, images):
        want = inference.predict_tiled(im, fn, **kw)
        assert mask.dtype == np.uint8 and set(np.unique(mask)) == {0, 255}
        np.testing.assert_array_equal(mask, want)

    def boom():
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(inference.predict_tiled_stream([("ok", lambda: images[1]), ("bad", boom)], fn, **kw))


def test_submit_cli_writes_segtpu_masks(tmp_path, linknet, monkeypatch):
    """The port's CLI and segtpu's, on one .pth written by save_snapshot,
    write the same .tif except where the probability is within 1e-3 of 0.5."""
    import cv2

    from segtpu import submit_cli as jax_submit
    from segtpu_torch import submit_cli

    module, params, stats, model = linknet
    data = tmp_path / "data" / "images"
    data.mkdir(parents=True)
    image = np.random.RandomState(8).randint(0, 256, (80, 72, 3)).astype(np.uint8)
    cv2.imwrite(str(data / "tile1.png"), image[..., ::-1])
    # centre the model's output on the threshold so that the mask is not constant
    fn = make_predict_step(model)
    probs = inference.predict_tiled(image, fn, _inria()[0], patch_size=64, batch_size=8,
                                    device="cpu")
    median_logit = float(np.log(np.median(probs) / (1 - np.median(probs))))
    with torch.no_grad():
        model.finalconv3.bias -= median_logit
    try:
        save_snapshot(str(tmp_path / "linknet34_checkpoint.pth"), model, epoch=1, loss=0.5,
                      train_history={}, args="test")
        probs = inference.predict_tiled(image, fn, _inria()[0], patch_size=64, batch_size=8,
                                        device="cpu")
    finally:
        with torch.no_grad():
            model.finalconv3.bias += median_logit
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SEGTPU_NO_COMPILE_CACHE", "1")
    common = ["-m", "linknet34", "-c", "linknet34_checkpoint.pth", "-p", "64", "-b", "8",
              "-dd", str(tmp_path / "data")]
    submit_cli.main(common + ["--submits-dir", "port", "--device", "cpu"])
    jax_submit.main(common + ["--submits-dir", "segtpu"])
    name = os.path.join("inria_linknet34_64_rgb", "tile1.tif")
    got = cv2.imread(os.path.join("port", name), cv2.IMREAD_GRAYSCALE)
    want = cv2.imread(os.path.join("segtpu", name), cv2.IMREAD_GRAYSCALE)
    assert got.shape == (80, 72) and set(np.unique(got)) == {0, 255}
    settled = np.abs(probs - 0.5) > 1e-3
    np.testing.assert_array_equal(got[settled], want[settled])
