"""The port's host tile I/O (``segtpu_torch/native``): the native tile
extractor and merge against the NumPy split and merge of ``ImageSlicer``
(their plain versions) bit for bit, against segtpu's tiles and
``segtpu.native``'s functions, the fallback where there is no compiler, the build (a
hashed library under the git-ignored ``native/build``; a failed build
raises), and tiled prediction with the tiles cut on the host against the
device-sliced path on the CPU.

Small: images of 150 x 130 (and 97 x 61), tiles of 64 and 32, a 4-filter
UNet on the CPU.
"""

import numpy as np
import pytest
import torch

from segtpu import native as jax_native
from segtpu.tiles import ImageSlicer as JaxImageSlicer

from segtpu_torch import native
from segtpu_torch.augment import host as aug
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.inference import predict_tiled, predict_tiled_stream
from segtpu_torch.models import place_model, unet
from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.train.state import make_predict_step
from torch_port_util import tmp_path  # noqa: F401  (removed after use)


def _image(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


SPLIT_CASES = [((150, 130, 3), 64, 32, 0), ((97, 61), 32, 16, 0), ((150, 130, 1), 64, 48, 0),
               ((64, 96, 3), 32, 16, 16)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-t{c[1]}")
def test_split_batch_equals_split(case, dtype):
    """The native extractor's tiles are ``split``'s, stacked, bit for bit
    (reflect-101 margins read through virtual borders; an HW image gives C
    = 1), and segtpu's ``split``'s."""
    shape, tile, step, margin = case
    image = _image(shape, dtype, sum(shape) + tile)
    slicer = ImageSlicer(shape, tile, step, image_margin=margin)
    calls = native.extract_tiles.calls
    got = slicer.split_batch(image)
    assert native.extract_tiles.calls == calls + 1
    want = np.stack(slicer.split(image))
    if want.ndim == 3:
        want = want[..., None]
    assert got.dtype == image.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    theirs = np.stack(JaxImageSlicer(shape, tile, step, image_margin=margin).split(image))
    np.testing.assert_array_equal(got, theirs.reshape(got.shape))


@pytest.mark.parametrize("weight", ["mean", "pyramid"])
@pytest.mark.parametrize("channels", [1, 3])
def test_merge_equals_merge_numpy_and_segtpu(weight, channels):
    """The native merge's float64 canvases give ``merge_numpy``'s image bit
    for bit (the same products and sums in the same order per pixel), and
    segtpu's ``merge``'s."""
    slicer = ImageSlicer((150, 130), 64, 32, weight=weight)
    rng = np.random.RandomState(channels)
    tiles = [rng.normal(0.0, 1.0, (64, 64, channels)).astype(np.float32) for _ in slicer.crops]
    calls = native.merge_tiles.calls
    got = slicer.merge(tiles)
    assert native.merge_tiles.calls == calls + 1
    want = slicer.merge_numpy(tiles)
    assert got.dtype == np.float32 and got.shape == (150, 130, channels)
    np.testing.assert_array_equal(got, want)
    theirs = JaxImageSlicer((150, 130), 64, 32, weight=weight).merge(tiles)
    np.testing.assert_array_equal(got, theirs.reshape(got.shape))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-t{c[1]}")
def test_extract_and_merge_tiles_equal_segtpu_native(case, dtype):
    """``extract_tiles`` and ``merge_tiles`` against ``segtpu.native``'s
    functions of the same signatures on the same arguments, bit for bit."""
    shape, tile, step, margin = case
    image = _image(shape, dtype, sum(shape) + tile + 1)
    slicer = ImageSlicer(shape, tile, step, image_margin=margin)
    xs, ys = [c[0] for c in slicer.crops], [c[1] for c in slicer.crops]
    args = (xs, ys, tile, slicer.margin_top, slicer.margin_left)
    assert jax_native.available() and native.available()
    got = native.extract_tiles(image, *args)
    np.testing.assert_array_equal(got, jax_native.extract_tiles(image, *args))
    preds = got.astype(np.float32) / 7.0
    weight = slicer.compute_weight(tile)
    mine = native.merge_tiles(preds, xs, ys, weight, *slicer.target_shape)
    theirs = jax_native.merge_tiles(preds, xs, ys, weight, *slicer.target_shape)
    for a, b in zip(mine, theirs):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_without_a_compiler_the_slicer_takes_numpy(monkeypatch):
    """No ``g++``: ``available()`` is False and ``split_batch`` and
    ``merge`` give the NumPy paths' results, as segtpu's fallback does."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR / "absent")
    real_run = native.subprocess.run

    def no_gxx(cmd, *args, **kwargs):
        if cmd[0] == "g++":
            raise FileNotFoundError(2, "No such file or directory", "g++")
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    assert not native.available()
    slicer = ImageSlicer((97, 61), 32, 16)
    image = _image((97, 61), np.uint8, 3)
    calls = (native.extract_tiles.calls, native.merge_tiles.calls)
    tiles = slicer.split_batch(image)
    np.testing.assert_array_equal(tiles, np.stack(slicer.split(image))[..., None])
    preds = list(tiles.astype(np.float32))
    np.testing.assert_array_equal(slicer.merge(preds), slicer.merge_numpy(preds))
    assert (native.extract_tiles.calls, native.merge_tiles.calls) == calls


def test_native_build_is_hashed_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library sits in the git-ignored ``native/build`` under a hash of
    its source and flags; a source that does not compile raises with g++'s
    output, and nothing falls back to NumPy."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libtileio-")
    assert path == native.library_path() and path.exists()
    ignored = (native.BUILD_DIR.parents[2] / ".gitignore").read_text().split()
    assert "segtpu_torch/native/build/" in ignored
    broken = tmp_path / "tileio.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.library_path() != path
    with pytest.raises(RuntimeError, match="tile I/O build failed"):
        native.build()
    assert not any((tmp_path / "build").glob("*.so"))


def test_extract_tiles_refuses_other_dtypes():
    with pytest.raises(TypeError, match="uint8 or float32"):
        native.extract_tiles(np.zeros((8, 8, 1), np.float64), [0], [0], 4, 0, 0)


@pytest.fixture(scope="module")
def predict_fn():
    torch.manual_seed(0)
    return make_predict_step(place_model(unet.UNet(n_filters=4), "cpu"))


@pytest.mark.parametrize("tta", [True, False])
def test_predict_tiled_host_slicing_equals_device_slicing(predict_fn, tta):
    """``slice_on_device=False`` (host tiles, uploaded per chunk, the
    normalisation applied on the device) gives the device-sliced
    probabilities within 1e-6 on the CPU (the same tile values; without TTA
    the two batches reach the convolutions in different memory layouts), and
    the same 0/255 mask."""
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN,
                                                                 std=INRIA_STD))])
    image = _image((150, 130, 3), np.uint8, 5)
    kw = dict(test_transform=transform, patch_size=64, batch_size=16, tta=tta, device="cpu")
    want = predict_tiled(image, predict_fn, **kw)
    got = predict_tiled(image, predict_fn, slice_on_device=False, **kw)
    assert got.shape == (150, 130) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    masks = list(predict_tiled_stream([(0, lambda: image)], predict_fn, threshold=0.5,
                                      slice_on_device=False, **kw))
    np.testing.assert_array_equal(masks[0][1], ((want > 0.5) * 255).astype(np.uint8))
