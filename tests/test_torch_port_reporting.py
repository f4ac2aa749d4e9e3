"""The port's host-side tools against segtpu's on the CPU: the NumPy loss
mirrors, the loss-shape and experiment plots (the same data into the same
files), ``show_landmarks_batch``, and the list forms of the D4 TTA. All
bit for bit."""

import os

import numpy as np
import pytest
import torch

from segtpu.augment import tta_d4_aug as jax_tta_d4_aug
from segtpu.augment import tta_d4_deaug as jax_tta_d4_deaug
from segtpu.ops import numpy_losses as jax_numpy_losses
from segtpu.reporting import plot as jax_plot
from segtpu.reporting import plot_loss as jax_plot_loss
from segtpu.utils import show_landmarks_batch as jax_show_landmarks_batch

from segtpu_torch import train_cli
from segtpu_torch.augment import tta_d4_aug, tta_d4_aug_batch, tta_d4_deaug
from segtpu_torch.ops import numpy_losses
from segtpu_torch.reporting import plot, plot_loss
from segtpu_torch.utils import show_landmarks_batch
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

LOSSES = ["binary_crossentropy", "jaccard_coef", "jaccard_loss", "smooth_jaccard_loss",
          "bce_jaccard_loss", "bce_smooth_jaccard_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_numpy_losses_equal_segtpus(name):
    rng = np.random.RandomState(LOSSES.index(name))
    y_true = (rng.rand(32, 32) > 0.5).astype(np.float32)
    for y_pred in (rng.rand(32, 32).astype(np.float32), y_true, 1.0 - y_true):
        assert getattr(numpy_losses, name)(y_true, y_pred) == \
            getattr(jax_numpy_losses, name)(y_true, y_pred)


@pytest.mark.parametrize("index", range(4))
def test_loss_shapes_equal_segtpus(index):
    ours, theirs = plot_loss.LOSS_FUNCTIONS[index], getattr(
        jax_numpy_losses, plot_loss.LOSS_FUNCTIONS[index].__name__)
    assert plot_loss.loss_shape(ours, size=16, steps=50) == \
        jax_plot_loss.loss_shape(theirs, size=16, steps=50)


def test_plot_loss_main_writes_segtpus_files(tmp_path, monkeypatch):
    shape = plot_loss.loss_shape
    monkeypatch.setattr(plot_loss, "loss_shape", lambda fn: shape(fn, size=8, steps=20))
    monkeypatch.setattr(jax_plot_loss, "loss_shape", lambda fn: shape(fn, size=8, steps=20))
    plot_loss.main(["--out", str(tmp_path / "ours")])
    jax_plot_loss.main(["--out", str(tmp_path / "theirs")])
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs")) and len(names) == 4
    assert all((tmp_path / "ours" / n).read_bytes()[:4] == b"\x89PNG" for n in names)


def _experiments(root):
    """Two experiments' CSVs where the train CLI writes them, by its writer."""
    rng = np.random.RandomState(0)
    for name in ("shapes_linknet34_64_rgb_bce", "shapes_zf_unet_64_rgb_bce"):
        d = root / "shapes" / "bce" / name
        d.mkdir(parents=True)
        history = {k: [float(v) for v in rng.rand(5)]
                   for k in ("loss", "val_loss", "iou", "accuracy", "val_iou", "val_accuracy")}
        train_cli.write_history_csv(str(d / f"{name}.csv"), dict(epoch=list(range(5)), **history),
                                    append=False)
    return root


def test_discover_experiments_reads_the_cli_csvs_as_segtpu(tmp_path):
    root = _experiments(tmp_path)
    ours = plot.discover_experiments(str(root), "shapes", "bce")
    theirs = jax_plot.discover_experiments(str(root), "shapes", "bce")
    assert list(ours) == list(theirs) and len(ours) == 2
    for name in ours:
        assert ours[name].equals(theirs[name])
        assert list(ours[name].columns) == ["epoch", "loss", "val_loss", "iou", "accuracy",
                                            "val_iou", "val_accuracy"]


def test_plot_main_writes_segtpus_files(tmp_path):
    root = _experiments(tmp_path / "experiments")
    for module, out in ((plot, "ours"), (jax_plot, "theirs")):
        module.main(["--experiments-dir", str(root), "--dataset", "shapes", "--loss", "bce",
                     "--out", str(tmp_path / out)])
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs")) and len(names) == 4
    with pytest.raises(SystemExit, match="no experiment CSVs"):
        plot.main(["--experiments-dir", str(root), "--dataset", "dsb2018", "--loss", "bce"])


def test_show_landmarks_batch_draws_segtpus_grids(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 16, 16, 3).astype(np.float32)
    y = (rng.rand(4, 16, 16, 1) > 0.5).astype(np.float32)
    ours = show_landmarks_batch((torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                 torch.from_numpy(y.transpose(0, 3, 1, 2).copy())),
                                out=str(tmp_path / "ours.png"))
    theirs = jax_show_landmarks_batch((x, y), out=str(tmp_path / "theirs.png"))
    for a, b in zip(ours.axes, theirs.axes):
        np.testing.assert_array_equal(a.images[0].get_array(), b.images[0].get_array())
    assert (tmp_path / "ours.png").read_bytes()[:4] == b"\x89PNG"


def test_tta_list_forms_equal_segtpus():
    rng = np.random.RandomState(0)
    images = [rng.rand(6, 6, 3).astype(np.float32) for _ in range(2)]
    ours, theirs = tta_d4_aug(images), jax_tta_d4_aug(images)
    assert len(ours) == len(theirs) == 16
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    # the list order is the batch form's
    batch = tta_d4_aug_batch(torch.from_numpy(np.stack(images).transpose(0, 3, 1, 2).copy()))
    for i, a in enumerate(ours):
        np.testing.assert_array_equal(batch[i].numpy().transpose(1, 2, 0), a)
    preds = [rng.rand(6, 6, 1).astype(np.float32) for _ in range(16)]
    for a, b in zip(tta_d4_deaug(preds), jax_tta_d4_deaug(preds)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tta_d4_deaug(ours), images):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        tta_d4_deaug(preds[:7])
