"""segtpu's ``.ckpt`` snapshots in the port: the msgpack subset decoder and
encoder (segtpu_torch/compat/flax_msgpack.py) against the ``msgpack`` package
and flax's serialisation, ``load_flax_snapshot`` / ``submit_cli -c <dir>.ckpt``
on a snapshot written by segtpu's own ``save_snapshot``, and the port's
writer read back by segtpu's ``restore_snapshot``.
"""

import json
import os

import msgpack
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from segtpu import inference as jax_inference
from segtpu.augment import host as jax_aug
from segtpu.train import checkpoint as jax_checkpoint
from segtpu.train.state import TrainState

from segtpu_torch import inference, submit_cli
from segtpu_torch.augment import host as aug
from segtpu_torch.compat import flax_msgpack
from segtpu_torch.compat.jax_params import jax_from_state_dict, state_dict_from_jax
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.models import get_model
from segtpu_torch.train.checkpoint import load_flax_snapshot, save_flax_snapshot
from segtpu_torch.train.state import make_predict_step

from torch_port_util import jax_linknet34, jax_predict_fn
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

META = dict(loss=0.25, epoch=3, train_history={"epoch": [3], "loss": [0.5]})


@pytest.fixture(scope="module")
def segtpu_ckpt(module_tmp):
    """segtpu's LinkNet34 saved by segtpu's ``save_snapshot`` (Adam state
    included) into ``linknet34_checkpoint.ckpt``."""
    module, params, stats = jax_linknet34(2)
    state = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, stats), optax.adam(1e-3))
    path = module_tmp("ckpt") / "linknet34_checkpoint.ckpt"
    jax_checkpoint.save_snapshot(state, snapshot_path=str(path), args="-m linknet34", **META)
    return module, params, stats, path


def _assert_same(a, b, where="/"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}{k}/")
    elif isinstance(b, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, where


def test_decoder_equals_msgpack_on_a_segtpu_snapshot(segtpu_ckpt):
    """The port's decoder gives the ``msgpack`` package's tree (with flax's
    ext hook) for segtpu's ``state.msgpack``, and its encoder gives back the
    same bytes."""
    data = (segtpu_ckpt[3] / "state.msgpack").read_bytes()
    want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False)
    got = flax_msgpack.unpackb(data)
    _assert_same(got, want)
    assert set(got) == {"params", "batch_stats", "opt_state"}
    assert flax_msgpack.packb(got) == data


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -2 ** 15 - 1,
    -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, "", "a" * 31, "é" * 40, "b" * 300, "c" * 70000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, True, False, None,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)}],
    ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__") else v))
def test_scalars_and_containers_match_msgpack(value):
    """Each encoding width of the subset, both ways, against the package."""
    want = msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack.packb(value) == want
    assert flax_msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("array", [
    np.arange(7, dtype=np.float32), np.ones((2, 3, 4), np.float64), np.zeros((0, 3), np.int32),
    np.arange(6, dtype=np.uint8).reshape(2, 3), np.float32(1.5), np.int64(-3)],
    ids=["f32", "f64", "empty", "u8", "scalar_f32", "scalar_i64"])
def test_arrays_match_flax(array):
    """ndarray (ext 1) and numpy scalar (ext 3) leaves, both ways, against
    flax's ``to_bytes`` / ``msgpack_restore``."""
    tree = {"b": {"c": array}, "a": array}
    data = serialization.to_bytes(tree)
    assert flax_msgpack.packb(tree) == data
    _assert_same(flax_msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_bfloat16_and_bad_input():
    """A bfloat16 leaf comes back widened to float32 exactly; truncated data,
    trailing bytes and an unknown ext type are errors."""
    x = jnp.asarray([1.5, -2.25, 3e38, 1e-38], jnp.bfloat16)
    data = serialization.msgpack_serialize({"x": np.asarray(x)})
    got = flax_msgpack.unpackb(data)["x"]
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(x, np.float32))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack object"):
        flax_msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="ext type 9"):
        flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(9, b"x")))


def test_load_flax_snapshot_gives_segtpus_weights(segtpu_ckpt):
    """``load_flax_snapshot``: segtpu's params and batch stats through
    ``state_dict_from_jax``, bit for bit; the meta as segtpu wrote it."""
    _, params, stats, path = segtpu_ckpt
    sd, meta = load_flax_snapshot(str(path), "linknet34")
    want = state_dict_from_jax("linknet34", params, stats)
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert meta == dict(META, args="-m linknet34")


def test_submit_cli_serves_a_segtpu_ckpt(segtpu_ckpt, tmp_path, monkeypatch):
    """``submit_cli -c <dir>.ckpt``: the model it loads gives segtpu's tiled
    probabilities (atol 1e-4) on a seeded image, and the CLI writes that
    model's thresholded mask."""
    import cv2

    module, params, stats, path = segtpu_ckpt
    image = np.random.RandomState(5).randint(0, 256, (90, 80, 3)).astype(np.uint8)
    (tmp_path / "data" / "images").mkdir(parents=True)
    cv2.imwrite(str(tmp_path / "data" / "images" / "a.png"), image[..., ::-1])
    model = get_model("linknet34", device="cpu")
    meta = submit_cli.load_checkpoint(model, "linknet34", str(path))
    assert meta["epoch"] == 3
    ours = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    theirs = jax_aug.Sequential([jax_aug.ImageOnly(jax_aug.NormalizeImage(mean=INRIA_MEAN,
                                                                          std=INRIA_STD))])
    kw = dict(patch_size=64, batch_size=16, tta=True)
    got = inference.predict_tiled(image, make_predict_step(model), ours, device="cpu", **kw)
    want = jax_inference.predict_tiled(image, jax_predict_fn(module, params, stats), theirs, **kw)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    monkeypatch.chdir(tmp_path)
    submit_cli.main(["-m", "linknet34", "-c", str(path), "-p", "64", "-b", "16", "-dd", "data",
                     "--device", "cpu", "--submits-dir", "out"])
    mask = cv2.imread(os.path.join("out", "inria_linknet34_64_rgb", "a.tif"), cv2.IMREAD_GRAYSCALE)
    settled = np.abs(got - 0.5) > 1e-3
    np.testing.assert_array_equal(mask[settled], ((got > 0.5) * 255).astype(np.uint8)[settled])


def test_port_writer_is_read_by_segtpu(segtpu_ckpt, tmp_path):
    """``save_flax_snapshot`` of a port model: segtpu's ``restore_snapshot``
    (``restore_opt=False``, its submit path) gets the model's weights bit
    for bit and the meta; the bytes are flax's serialisation of the same
    tree; ``jax_from_state_dict`` inverts ``state_dict_from_jax``."""
    module, params, stats, _ = segtpu_ckpt
    model = get_model("linknet34", device="cpu", seed=9)
    sd = model.state_dict()
    path = tmp_path / "port.ckpt"
    save_flax_snapshot(str(path), "linknet34", sd, **META)
    template = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.tree_util.tree_map(jnp.asarray, stats), optax.adam(1e-3))
    restored, start_epoch, history, loss = jax_checkpoint.restore_snapshot(
        template, str(path), restore_opt=False)
    got = state_dict_from_jax("linknet34", jax.tree_util.tree_map(np.asarray, restored.params),
                              jax.tree_util.tree_map(np.asarray, restored.batch_stats))
    assert all(torch.equal(got[k], sd[k].float()) for k in got if not k.endswith("tracked"))
    assert (start_epoch, history, loss) == (META["epoch"] + 1, META["train_history"], META["loss"])
    p, s = jax_from_state_dict("linknet34", sd)
    data = (path / "state.msgpack").read_bytes()
    assert data == serialization.to_bytes({"params": p, "batch_stats": s, "opt_state": {}})
    assert json.loads((path / "meta.json").read_text())["args"] == ""
