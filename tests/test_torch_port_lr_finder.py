"""segtpu_torch.lr_finder against segtpu.lr_finder on the CPU: the schedule
and the smoothing bit for bit, and a 6-step sweep of a narrow UNet (4
filters, dropout off) that starts from segtpu's seeded weights, the losses
to rtol 1e-4 (the largest differences seen: 3.6e-7 relative with SGD,
1.1e-6 with Adam); then the command line, ``python -m
segtpu_torch.lr_finder``, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu import lr_finder as jax_lr_finder
from segtpu.models.unet import UNet as JaxUNet
from segtpu.ops import losses as jax_losses
from segtpu.train import optim as jax_optim
from segtpu.train.state import TrainState

from segtpu_torch import lr_finder
from segtpu_torch.compat.jax_params import _entries_unet, state_dict_from_entries
from segtpu_torch.models.unet import UNet
from segtpu_torch.ops import losses
from segtpu_torch.train import optim

from torch_port_util import _jax_variables, _no_dropout
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

torch.set_num_threads(2)


def test_schedule_and_smoothing_bit_equal():
    lrs = np.array(optim.lr_finder_schedule(30, 1e-8), dtype=np.float32)
    np.testing.assert_array_equal(lrs, np.array(jax_optim.lr_finder_schedule(30, 1e-8),
                                                dtype=np.float32))
    losses_ = np.random.RandomState(0).rand(30).astype(np.float32)
    for taps in (4, 3):
        np.testing.assert_array_equal(lr_finder.smooth_losses(losses_, taps),
                                      jax_lr_finder.smooth_losses(losses_, taps))


def _batches(n=4):
    rng = np.random.RandomState(1)
    return [(rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             (rng.rand(2, 32, 32, 1) > 0.6).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("optimizer,min_lr", [("sgd", 1e-3), ("adam", 1e-8)])
def test_sweep_matches_segtpu(optimizer, min_lr):
    """Six steps at ``min_lr`` * 2^i over a loader of four batches
    (restarted after the fourth), from the same weights: the same losses.
    SGD sweeps from 1e-3, so that the steps move the loss; Adam from the
    finder's own 1e-8: its first steps move each weight by about lr
    whatever the size of its gradient, so at 1e-3 a gradient that is
    rounding noise in both programs moves the loss by 9e-4 relative."""
    module = JaxUNet(n_filters=4, final_dropout=0.0)
    params, stats = _jax_variables(module, (1, 32, 32, 3))
    batches = _batches()
    tx = jax_optim.get_optimizer(optimizer, 1e-8)
    state = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, stats), tx)
    want_lrs, want = jax_lr_finder.find_optimal_lr(state, jax_losses.get_loss("bce_jaccard"),
                                                   batches, n_steps=6, min_lr=min_lr)

    model = _no_dropout(UNet(n_filters=4))
    model.load_state_dict(state_dict_from_entries(_entries_unet(), params, stats), strict=False)
    opt = optim.get_optimizer(optimizer, model.parameters(), 1e-8)
    lrs, got = lr_finder.find_optimal_lr(model, opt, losses.get_loss("bce_jaccard"), batches,
                                         n_steps=6, min_lr=min_lr, device="cpu")
    np.testing.assert_array_equal(lrs, want_lrs)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(set(got.tolist())) > 1  # the batches differ


def test_main_sweeps_and_plots(tmp_path):
    out = tmp_path / "loss_plot.png"
    lrs, losses_ = lr_finder.main(["-m", "zf_unet", "-d", "shapes", "-p", "32", "-b", "2",
                                   "-l", "bce", "-o", "sgd", "-w", "1", "--device", "cpu",
                                   "--out", str(out)])
    assert len(lrs) == len(losses_) == 30 and np.isfinite(losses_).all()
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_writes_a_png(tmp_path, monkeypatch):
    """Where matplotlib is not installed the curve is drawn into a plain
    PNG: an 800 x 500 RGB image whose rows decode, the curve on it."""
    import struct
    import sys
    import zlib

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    lrs = np.array(optim.lr_finder_schedule(30, 1e-8), dtype=np.float32)
    out = tmp_path / "plain.png"
    lr_finder.plot_losses(lrs, np.linspace(1.0, 0.2, 30, dtype=np.float32), str(out))
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    w, h = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    length = struct.unpack(">I", data[idat - 4:idat])[0]
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + length]), np.uint8)
    img = rows.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)
    assert (w, h) == (800, 500) and (img == (31, 119, 180)).all(-1).sum() > 500


def test_main_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lr_finder.main(["-m", "zf_unet", "-d", "shapes", "-p", "32",
                        "--out", str(tmp_path / "x.png")])
