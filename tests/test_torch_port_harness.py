"""segtpu_torch's training harness against segtpu's: meters, PR-curve
counts, per-sample streams, the loader, image grids, the convolution
penalty, the frozen-encoder set and two epochs of the loop; then the port's
own train CLI on the CPU (files, CSV, resume, seeds, freezing, the penalty,
shapes-device, the flags of later slices, the writer, optional packages).

Small: LinkNet34 at 2 x 3 x 64 x 64 (``-p 64 -b 2``, ``-s 1`` or ``-s 2``:
one or two train steps and one validation batch an epoch), fp32 on the CPU,
the kernels through their plain versions, torch on two threads (the suite
runs six test processes side by side). Inputs are made from a seed with
numpy; weights come from ``tests/torch_port_util.py``.
"""

import copy
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.augment import host as jax_host
from segtpu.data import pipeline as jax_pipeline
from segtpu.data import shapes as jax_shapes
from segtpu.ops import losses as jax_losses
from segtpu.ops import meters as jax_meters
from segtpu.ops import metrics as jax_metrics
from segtpu.regularization import conv2d_regularization as jax_conv2d_regularization
from segtpu.train import loop as jax_loop
from segtpu.train import optim as jax_optim
from segtpu.train.state import TrainState
from segtpu.train.state import make_eval_step as jax_make_eval_step
from segtpu.train.state import make_train_step as jax_make_train_step
from segtpu.utils import make_grid as jax_make_grid

from segtpu_torch import regularization, train_cli, train_reg_cli
from segtpu_torch.augment import host
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import get_dataset, pipeline, shapes
from segtpu_torch.models import ENCODER_PREFIXES, get_model, layers
from segtpu_torch.ops import losses, meters, metrics
from segtpu_torch.train import loop, optim
from segtpu_torch.train import state as state_mod
from segtpu_torch.train.checkpoint import load_snapshot, restore_snapshot, save_snapshot
from segtpu_torch.train.state import make_eval_step, make_train_step
from segtpu_torch.utils import count_parameters, make_grid

from torch_port_util import jax_linknet34, port_linknet34
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

HISTORY_KEYS = ["epoch", "loss", "val_loss", "iou", "accuracy", "val_iou", "val_accuracy"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Meters, PR-curve counts, per-sample streams
# ---------------------------------------------------------------------------

def test_meters_match_segtpu():
    rng = np.random.RandomState(0)
    ours, theirs = meters.AverageMeter(), jax_meters.AverageMeter()
    for _ in range(7):
        v, n = float(rng.normal()), int(rng.randint(1, 5))
        ours.update(v, n)
        theirs.update(v, n)
        assert vars(ours) == vars(theirs)
    assert str(ours) == str(theirs) and repr(ours) == repr(theirs)

    pr_ours, pr_theirs = meters.PRCurveMeter(), jax_meters.PRCurveMeter()
    assert np.array_equal(pr_ours.thresholds, pr_theirs.thresholds)
    for _ in range(3):
        counts = [rng.randint(0, 50, 127).astype(np.int32) for _ in range(4)]
        pr_ours.update_counts(*counts)
        pr_theirs.update_counts(*counts)
    for field in ("tp", "tn", "fp", "fn"):
        assert np.array_equal(getattr(pr_ours, field), getattr(pr_theirs, field))
    np.testing.assert_array_equal(pr_ours.precision(), pr_theirs.precision())
    np.testing.assert_array_equal(pr_ours.recall(), pr_theirs.recall())


def _far_from_thresholds(shape, seed, n=127, margin=1e-6):
    """Seeded logits whose sigmoid lies more than ``margin`` from every
    threshold k/n: the two sides' sigmoids may differ by an ulp, which must
    not move a pixel across a threshold."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(0.0, 3.0, shape).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    thresholds = (np.arange(n, dtype=np.float32) / n).astype(np.float64)
    near = np.abs(p[..., None] - thresholds).min(-1) <= margin
    logits[near] += 0.01
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    assert np.abs(p[..., None] - thresholds).min() > margin
    return logits


def test_pr_curve_counts_match_segtpu():
    """Exact counts on seeded NHWC logits (sigmoids kept more than 1e-6 from
    every threshold), also with targets that are all one class."""
    logits = _far_from_thresholds((2, 24, 20, 1), 3)
    targets = (np.random.RandomState(4).uniform(size=logits.shape) > 0.6).astype(np.float32)
    for t in (targets, np.zeros_like(targets), np.ones_like(targets)):
        want = jax_metrics.pr_curve_counts(jnp.asarray(logits), jnp.asarray(t))
        got = metrics.pr_curve_counts(torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
                                      torch.from_numpy(t.transpose(0, 3, 1, 2).copy()))
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == (127,)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_derive_sample_rng_matches_segtpu():
    for key in ((0, 0, 0), (7, 3, 1234), (2 ** 40, 99, 5)):
        ours, theirs = host.derive_sample_rng(*key), jax_host.derive_sample_rng(*key)
        assert [ours.random() for _ in range(5)] == [theirs.random() for _ in range(5)]
        assert ours.randint(0, 10 ** 9) == theirs.randint(0, 10 ** 9)
    with host.bind_sample_rng(1, 2, 3) as bound, jax_host.bind_sample_rng(1, 2, 3):
        assert host.DEFAULT_RNG.uniform(0, 5) == jax_host.DEFAULT_RNG.uniform(0, 5)
        assert host.DEFAULT_RNG.choice(range(100)) == jax_host.DEFAULT_RNG.choice(range(100))
        assert isinstance(bound, type(host.derive_sample_rng(0, 0, 0)))


def test_bind_sample_rng_restores_the_outer_binding():
    """The port's one repair: a nested binding leaves the outer one bound
    (segtpu's ``__exit__`` sets None)."""
    with host.bind_sample_rng(1, 0, 0):
        first = host.DEFAULT_RNG.random()
        with host.bind_sample_rng(9, 9, 9):
            host.DEFAULT_RNG.random()
        second = host.DEFAULT_RNG.random()
    ref = host.derive_sample_rng(1, 0, 0)
    assert [first, second] == [ref.random(), ref.random()]
    assert host._DefaultRNG._impl() is host._random


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

class _Jittered:
    """A map-style set drawing one number per sample from ``rng`` (the
    host-augmentation default stream), so the loader's per-sample binding
    decides the arrays."""

    def __init__(self, base, rng):
        self.base, self.rng = base, rng

    def __len__(self):
        return len(self.base)

    def set_epoch(self, epoch):
        self.base.set_epoch(epoch)

    def __getitem__(self, i):
        x, y = self.base[i]
        return x + np.float32(self.rng.uniform(0.0, 1.0)), y


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("sample_seed", [None, 5])
def test_loader_matches_segtpu(workers, sample_seed):
    """Same index order, same arrays, bit for bit, over two epochs, shuffled
    and not; with ``sample_seed`` the samples draw from the bound stream."""
    def make(mod_shapes, mod_host):
        base = mod_shapes.ShapesDataset(7, 16, seed=3)
        return base if sample_seed is None else _Jittered(base, mod_host.DEFAULT_RNG)

    for shuffle in (True, False):
        ours = pipeline.DataLoader(make(shapes, host), 2, shuffle=shuffle, workers=workers,
                                   seed=11, sample_seed=sample_seed)
        theirs = jax_pipeline.DataLoader(make(jax_shapes, jax_host), 2, shuffle=shuffle,
                                         workers=workers, seed=11, sample_seed=sample_seed)
        assert len(ours) == len(theirs) == 3
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 3
            for (x1, y1), (x2, y2) in zip(got, want):
                assert x1.dtype == x2.dtype and x1.shape == x2.shape == (2, 16, 16, 3)
                assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    ours = pipeline.DataLoader(shapes.ShapesDataset(7, 16), 2, drop_last=False)
    assert len(ours) == 4 and [len(x) for x, _ in ours] == [2, 2, 2, 1]


def test_subset_matches_segtpu():
    ours = pipeline.Subset(shapes.ShapesDataset(9, 16, seed=2), 4)
    theirs = jax_pipeline.Subset(jax_shapes.ShapesDataset(9, 16, seed=2), 4)
    ours.set_epoch(1)
    theirs.set_epoch(1)
    assert len(ours) == len(theirs) == 4
    assert all(np.array_equal(ours[i][0], theirs[i][0]) for i in range(4))
    assert len(pipeline.Subset(shapes.ShapesDataset(3, 16), 10)) == 3


def test_prefetch_to_device_on_cpu():
    """NHWC numpy batches become contiguous NCHW float32 tensors; tensors
    already on the device pass through untouched."""
    batches = [(np.random.RandomState(i).normal(size=(2, 5, 6, 3)).astype(np.float32),
                np.zeros((2, 5, 6, 1), np.float32)) for i in range(3)]
    out = list(pipeline.prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 3
    for (x, y), (xn, _) in zip(out, batches):
        assert x.shape == (2, 3, 5, 6) and y.shape == (2, 1, 5, 6) and x.is_contiguous()
        assert torch.equal(x, torch.from_numpy(xn.transpose(0, 3, 1, 2).copy()))
    t = (torch.ones(1, 3, 4, 4), torch.zeros(1, 1, 4, 4))
    (x, y), = pipeline.prefetch_to_device([t], "cpu")
    assert x is t[0] and y is t[1]


def test_device_shapes_loader():
    """The registry's shapes-device split: 1024/128 samples, one class;
    train batches keyed on (seed, epoch, batch), validation fixed across
    epochs; ``take`` cuts; grayscale is the luma of the raw RGB batch."""
    train, val, n_classes = get_dataset("shapes-device", patch_size=32)
    assert (len(train), len(val), n_classes) == (1024, 128, 1)
    assert not train.fixed and val.fixed and val.seed == train.seed + 1_000_000
    train, val = train.take(6), val.take(4)
    tl, vl = train.loader(2, "cpu"), val.loader(2, "cpu")
    assert len(tl) == 3 and len(vl) == 2
    epoch0 = list(tl)
    assert len(epoch0) == 3 and epoch0[0][0].shape == (2, 3, 32, 32)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(epoch0, list(tl)))
    tl.set_epoch(1)
    assert not torch.equal(epoch0[0][0], next(iter(tl))[0])
    v0 = next(iter(vl))
    vl.set_epoch(5)
    assert torch.equal(v0[0], next(iter(vl))[0])

    gray = shapes.DeviceShapesSet(4, 32, grayscale=True)
    assert gray.num_channels == 1
    x, y = next(iter(gray.loader(2, "cpu")))
    raw, y_raw = shapes.DeviceShapes(32, normalize=False, device="cpu").batch(
        2, torch.Generator().manual_seed(shapes._batch_seed(0, 0, 0)))
    luma = (raw * torch.from_numpy(shapes.GRAY_WEIGHTS).view(1, 3, 1, 1)).sum(1, keepdim=True)
    torch.testing.assert_close(
        x, (luma / 255.0 - shapes.IMAGENET_GRAY_MEAN) / shapes.IMAGENET_GRAY_STD)
    assert torch.equal(y, y_raw)


def test_host_shapes_split_matches_segtpu():
    ours, theirs = get_dataset("shapes", patch_size=16), jax_shapes.SHAPES(16)
    assert ours[2] == theirs[2] == 1
    for a, b in zip(ours[:2], theirs[:2]):
        assert (len(a), a.seed) == (len(b), b.seed)
        assert np.array_equal(a[3][0], b[3][0])


# ---------------------------------------------------------------------------
# Grids, parameter counts, the penalty, the frozen set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8, 6, 3), (3, 8, 8, 1), (10, 4, 4, 3), (2, 6, 6)])
def test_make_grid_matches_segtpu(shape):
    nhwc = np.random.RandomState(len(shape)).normal(size=shape).astype(np.float32)
    nchw = nhwc.transpose(0, 3, 1, 2) if nhwc.ndim == 4 else nhwc
    want = jax_make_grid(nhwc)
    np.testing.assert_array_equal(make_grid(nchw), want)
    np.testing.assert_array_equal(make_grid(torch.from_numpy(np.ascontiguousarray(nchw))), want)
    np.testing.assert_array_equal(make_grid(nchw, normalize=False),
                                  jax_make_grid(nhwc, normalize=False))


@pytest.fixture(scope="module")
def linknet():
    module, params, stats = jax_linknet34(0)
    return module, params, stats


def _marked(tree, under):
    """``tree`` with every leaf 1.0 where ``under(path)``, else 0.0."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return np.full(np.shape(node), 1.0 if under(path) else 0.0, np.float32)
    return walk(tree, ())


def _selected(params, stats, under):
    """Port parameter names whose segtpu leaves satisfy ``under``, through
    ``state_dict_from_jax``."""
    model = get_model("linknet34", device="cpu")
    sd = state_dict_from_jax("linknet34", _marked(params, under), stats)
    names = {n for n, _ in model.named_parameters()}
    assert names <= set(sd)
    return {n for n in names if float(sd[n].abs().max()) == 1.0}, model


def test_conv2d_regularization_matches_segtpu(linknet):
    """The same value on the same weights (rtol 1e-6: fp32 sums of 21.8M
    terms in two orders), over the same layers: segtpu's ``Conv_0``
    subtrees, mapped by ``state_dict_from_jax``, are the port's
    ``nn.Conv2d`` modules."""
    _, params, stats = linknet
    model = port_linknet34(params, stats)
    for l1, l2 in ((5e-4, 5e-4), (1e-3, 2e-2)):
        want = float(jax.jit(jax_conv2d_regularization, static_argnums=(1, 2))(params, l1, l2))
        got = regularization.conv2d_regularization(model, l1, l2)
        assert got.shape == () and float(got.detach()) == pytest.approx(want, rel=1e-6)
    chosen, fresh = _selected(params, stats, lambda path: "Conv_0" in path)
    convs = {f"{n}.{k}" for n, m in fresh.named_modules() if isinstance(m, torch.nn.Conv2d)
             for k in ("weight", "bias") if getattr(m, k) is not None}
    assert chosen == convs
    assert not any(n.startswith(("finaldeconv1", "decoder1.deconv2")) for n in chosen)
    # encoder: firstconv, 32 block convs, 3 downsample convs; decoder 8; head 2
    assert len({n.rsplit(".", 1)[0] for n in convs}) == 36 + 8 + 2


def test_freeze_encoder_set_matches_segtpu(linknet):
    """``--freeze-encoder`` freezes what segtpu's ENCODER_SPECS path
    ``("encoder",)`` holds, mapped by ``state_dict_from_jax``."""
    from segtpu.compat.encoder_weights import encoder_paths
    _, params, stats = linknet
    (path,), = [encoder_paths("linknet34", params)]
    chosen, model = _selected(params, stats, lambda p: p[:len(path)] == path)
    prefixes = ENCODER_PREFIXES["linknet34"]
    assert chosen == {n for n, _ in model.named_parameters() if n.startswith(prefixes)}
    assert len(chosen) == 3 + 16 * 6 + 3 * 3  # stem, 16 blocks, 3 downsample branches


def test_count_parameters_matches_segtpu(linknet):
    from segtpu.utils import count_parameters as jax_count_parameters
    _, params, stats = linknet
    assert count_parameters(port_linknet34(params, stats)) == jax_count_parameters(params)


# ---------------------------------------------------------------------------
# Two epochs of the loop against segtpu's loop with its jitted step
# ---------------------------------------------------------------------------

LOOP_LR = 0.02
LOOP_KEYS = ("loss", "val_loss", "iou", "accuracy", "val_iou", "val_accuracy")
# Per-epoch values are means over 2 train batches or 1 val batch of
# LinkNet34 at 2 x 64 x 64, after 2 and 4 SGD steps. Against a float64 run
# of the port (the same loop, model and inputs in float64), the port's fp32
# run is off by at most 2.1e-7 in loss, val_loss, iou and val_iou, and
# segtpu's by at most 4.1e-6: the gate for those is 3e-5, absolute (the
# values lie in [0, 1]). Accuracy counts pixels on either side of 0.5, and
# at random init many logits sit near 0: one pixel that crosses moves an
# epoch's accuracy by 6.1e-5 (train) or 1.2e-4 (val). The fp32 port is 6
# train pixels from float64 (3.7e-4), segtpu 2 (1.2e-4); the gate is 1e-3.
LOOP_ATOL = {"loss": 3e-5, "val_loss": 3e-5, "iou": 3e-5, "val_iou": 3e-5,
             "accuracy": 1e-3, "val_accuracy": 1e-3}


def _loop_history(run_epoch):
    history = {k: [] for k in LOOP_KEYS}
    for epoch in (0, 1):
        (tl, ts), (vl, vs) = run_epoch(epoch)
        for k, v in (("loss", tl.avg), ("val_loss", vl.avg), ("iou", ts["iou"].avg),
                     ("accuracy", ts["accuracy"].avg), ("val_iou", vs["iou"].avg),
                     ("val_accuracy", vs["accuracy"].avg)):
            history[k].append(v)
    return history


def _port_loop(params, stats, dtype):
    model = port_linknet34(params, stats).to(dtype)
    model.finaldrop1.p = 0.0
    loss_fn, names = losses.get_loss("bce_jaccard"), list(metrics.default_metrics())
    step = make_train_step(model, optim.get_optimizer("sgd", model.parameters(), LOOP_LR),
                           loss_fn, metrics.default_metrics())
    evaluate = make_eval_step(model, loss_fn, metrics.default_metrics())

    def train_step(x, y, lr):
        return step(x.to(dtype), y.to(dtype), lr)

    def eval_step(x, y):
        return evaluate(x.to(dtype), y.to(dtype))

    train_step.model = eval_step.model = model
    trainloader = pipeline.DataLoader(shapes.ShapesDataset(4, 64), 2, shuffle=True, workers=2)
    validloader = pipeline.DataLoader(shapes.ShapesDataset(2, 64, seed=1_000_000), 2, workers=2)

    def run_epoch(epoch):
        trainloader.set_epoch(epoch)
        return (loop.run_train_epoch(train_step, trainloader, LOOP_LR, epoch, names, device="cpu"),
                loop.run_validate_epoch(eval_step, validloader, epoch, names, device="cpu"))

    return _loop_history(run_epoch)


def _segtpu_loop(module, params, stats):
    loss_fn, names = jax_losses.get_loss("bce_jaccard"), list(jax_metrics.default_metrics())
    state = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, stats),
                              jax_optim.get_optimizer("sgd", LOOP_LR))
    trainloader = jax_pipeline.DataLoader(jax_shapes.ShapesDataset(4, 64), 2, shuffle=True,
                                          workers=2)
    validloader = jax_pipeline.DataLoader(jax_shapes.ShapesDataset(2, 64, seed=1_000_000), 2,
                                          workers=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
        step = jax_make_train_step(loss_fn, jax_metrics.default_metrics(), donate=False)
        evaluate = jax_make_eval_step(loss_fn, jax_metrics.default_metrics())
        rng = jax.random.PRNGKey(0)

        def run_epoch(epoch):
            nonlocal state
            trainloader.set_epoch(epoch)
            state, tl, ts = jax_loop.run_train_epoch(step, state, trainloader, LOOP_LR, rng, epoch,
                                                     names, progress=False)
            return (tl, ts), jax_loop.run_validate_epoch(evaluate, state, validloader, epoch,
                                                         names, progress=False)

        return _loop_history(run_epoch)


def test_two_epoch_loop_matches_segtpu(linknet):
    module, params, stats = linknet
    want = _segtpu_loop(module, params, stats)
    got = _port_loop(params, stats, torch.float32)
    for k in LOOP_KEYS:
        assert len(got[k]) == len(want[k]) == 2
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LOOP_ATOL[k], err_msg=k)
    assert got["loss"][1] != got["loss"][0]


# ---------------------------------------------------------------------------
# The port's train CLI on the CPU
# ---------------------------------------------------------------------------

def _cli_args(exp_dir, *extra, dataset="shapes", epochs=1, steps=1, optimizer="sgd"):
    return ["-m", "linknet34", "-d", dataset, "-l", "bce_jaccard", "-o", optimizer,
            "-lr", "1e-3", "-b", "2", "-p", "64", "-s", str(steps), "-e", str(epochs),
            "--device", "cpu", "--no-tensorboard", "--experiments-dir", str(exp_dir), *extra]


def _experiment(exp_dir, dataset="shapes"):
    name = f"{dataset}_linknet34_64_rgb_bce_jaccard"
    return exp_dir / dataset / "bce_jaccard" / name, name


ADAM_2 = dict(steps=2, optimizer="adam")


def _no_dropout(args, num_channels):
    model = get_model(args.model, patch_size=args.patch_size, num_channels=num_channels,
                      device="cpu")
    model.finaldrop1.p = 0.0
    return model


@pytest.fixture(scope="module")
def straight(module_tmp):
    """``-e 2 -s 2`` in one run, dropout off, Adam."""
    exp = module_tmp("straight")
    history = train_cli.main(_cli_args(exp, epochs=2, **ADAM_2), model_builder=_no_dropout)
    return exp, history


def test_cli_writes_files_and_pandas_csv(straight):
    exp, history = straight
    d, name = _experiment(exp)
    assert list(history) == HISTORY_KEYS and history["epoch"] == [0, 1]
    assert all(math.isfinite(v) for k in HISTORY_KEYS[1:] for v in history[k])
    assert (d / "arguments.txt").read_text() == " ".join(_cli_args(exp, epochs=2, **ADAM_2))
    text = (d / f"{name}.csv").read_text()
    assert text.splitlines()[0] == ",".join(HISTORY_KEYS)
    assert text == pd.DataFrame(history).to_csv(index=False)
    for kind in ("checkpoint", "snapshot"):
        ckpt = torch.load(d / f"linknet34_{kind}.pth", weights_only=False)
        assert set(ckpt) == {"model", "optimizer", "epoch", "loss", "train_history", "args"}
        assert ckpt["optimizer"]["state"] and ckpt["optimizer"]["param_groups"][0]["lr"] == 1e-3
    assert torch.load(d / "linknet34_snapshot.pth", weights_only=False)["epoch"] == 1


def test_write_history_csv_matches_pandas(tmp_path):
    """Awkward values too: NaN, inf, tiny and large floats, numpy floats,
    appended rows without a header."""
    history = {"epoch": [0, 1, 2], "loss": [float("nan"), 1e-20, 3.0],
               "val_loss": [float("inf"), np.float32(0.1), 1.2345678901234567e16],
               "iou": [np.float64(0.25), -0.0, 1 / 3]}
    path = tmp_path / "h.csv"
    train_cli.write_history_csv(str(path), history, append=False)
    train_cli.write_history_csv(str(path), history, append=True)
    df = pd.DataFrame(history)
    assert path.read_text() == df.to_csv(index=False) + df.to_csv(index=False, header=False)


def test_cli_resume_is_bit_equal_to_a_straight_run(straight, tmp_path):
    """``-e 1`` then ``-e 2 -r``: the resumed run restores the best
    checkpoint (epoch 0) with its Adam state, and ends with the straight
    run's history, CSV rows and weights, bit for bit."""
    exp, history = straight
    train_cli.main(_cli_args(tmp_path, epochs=1, **ADAM_2), model_builder=_no_dropout)
    resumed = train_cli.main(_cli_args(tmp_path, "-r", epochs=2, **ADAM_2),
                             model_builder=_no_dropout)
    assert resumed == history
    (d, name), (d0, _) = _experiment(tmp_path), _experiment(exp)
    rows = (d / f"{name}.csv").read_text().splitlines()
    want = (d0 / f"{name}.csv").read_text().splitlines()
    assert rows[0] == want[0] and rows[1] == want[1] and rows[-2:] == want[1:]
    assert len(rows) == 4  # header, epoch 0 of the first run, then the resumed history
    got_sd, _ = load_snapshot(str(d / "linknet34_snapshot.pth"))
    want_sd, _ = load_snapshot(str(d0 / "linknet34_snapshot.pth"))
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)


def test_cli_seeded_runs_are_identical_with_dropout(tmp_path):
    texts = []
    for run in ("a", "b"):
        train_cli.main(_cli_args(tmp_path / run, "--seed", "7", "-w", "3", "--snapshot-every", "0"))
        d, name = _experiment(tmp_path / run)
        texts.append((d / f"{name}.csv").read_text())
    assert texts[0] == texts[1]


def test_cli_freeze_encoder(tmp_path):
    """Every encoder parameter keeps its initial bits; the decoder trains.
    (The encoder's BatchNorm running statistics still update, as segtpu's
    batch_stats do under its mask.)"""
    train_cli.main(_cli_args(tmp_path, "--freeze-encoder"))
    d, _ = _experiment(tmp_path)
    after, _ = load_snapshot(str(d / "linknet34_snapshot.pth"))
    before = get_model("linknet34", device="cpu").state_dict()
    prefixes = ENCODER_PREFIXES["linknet34"]
    params = [n for n, _ in get_model("linknet34", device="cpu").named_parameters()]
    frozen = [n for n in params if n.startswith(prefixes)]
    assert len(frozen) == 108
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    assert not torch.equal(after["decoder1.conv1.weight"], before["decoder1.conv1.weight"])
    assert not torch.equal(after["encoder1.0.bn1.running_mean"],
                           before["encoder1.0.bn1.running_mean"])

    def tiny(args, num_channels):
        return torch.nn.Sequential(torch.nn.Conv2d(num_channels, 1, 1))

    with pytest.raises(SystemExit, match="no encoder"):
        train_cli.main(_cli_args(tmp_path, "--freeze-encoder") + ["-m", "tiny"],
                       model_builder=tiny)


def test_train_step_rejects_an_unknown_trainable_name():
    model = torch.nn.Conv2d(1, 1, 1)
    with pytest.raises(ValueError, match="no parameter"):
        make_train_step(model, optim.get_optimizer("sgd", model.parameters(), 0.1),
                        losses.get_loss("bce"), trainable_mask={"weight", "nope"})


def test_param_penalty_adds_its_gradient():
    """The regularised step's gradients minus the plain step's are the
    gradient of ``conv2d_regularization`` (l1 sign(w) on the kernels, 2 l2 b
    on the biases, 0 elsewhere), to 1e-5 of the step's largest |g|; the
    logged loss stays the unscaled loss."""
    l1, l2 = 5e-4, 5e-2
    x, y = shapes.to_nchw([shapes.ShapesDataset(2, 32, seed=5)[i] for i in range(2)])
    grads, logs = [], []
    fresh = get_model("linknet34", device="cpu")
    fresh.finaldrop1.p = 0.0
    for penalty in (None, regularization.make_conv2d_penalty(l1, l2)):
        model = copy.deepcopy(fresh)
        step = make_train_step(model, optim.get_optimizer("sgd", model.parameters(), 0.0),
                               losses.get_loss("bce_jaccard"), param_penalty=penalty)
        logs.append(step(x, y, 0.0))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert float(logs[0]["loss"]) == float(logs[1]["loss"])
    scale = float(logs[0]["grad_absmax"])
    convs = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    for name, g in grads[0].items():
        owner, kind = name.rsplit(".", 1)
        want = torch.zeros_like(g)
        if owner in convs:
            p = getattr(convs[owner], kind).detach()
            want = l1 * torch.sign(p) if kind == "weight" else 2 * l2 * p
        torch.testing.assert_close(grads[1][name] - g, want, rtol=0, atol=1e-5 * scale,
                                   msg=name)


def test_reg_cli_trains(tmp_path):
    history = train_reg_cli.main(_cli_args(tmp_path), l1_factor=1e-3)
    assert history["epoch"] == [0] and math.isfinite(history["loss"][0])


def test_cli_shapes_device_with_cap_sgdr_and_resume(tmp_path, monkeypatch):
    lrs = []
    real = train_cli.run_train_epoch

    def record(train_step, loader, lr, epoch, *args, **kwargs):
        lrs.append(lr)
        assert len(loader) == 1
        return real(train_step, loader, lr, epoch, *args, **kwargs)

    monkeypatch.setattr(train_cli, "run_train_epoch", record)
    history = train_cli.main(_cli_args(tmp_path, "-sgdr", dataset="shapes-device"))
    assert history["epoch"] == [0]
    history = train_cli.main(_cli_args(tmp_path, "-sgdr", "-r", dataset="shapes-device",
                                       epochs=2))
    assert history["epoch"] == [0, 1] and all(math.isfinite(v) for v in history["loss"])
    assert lrs == [optim.cosine_annealing_lr(e, 1e-3) for e in (0, 1)]
    d, name = _experiment(tmp_path, "shapes-device")
    assert len((d / f"{name}.csv").read_text().splitlines()) == 4


@pytest.mark.parametrize("flag", [["--model-parallel", "2"], ["--s2d"], ["--remat"], ["--packed"],
                                  ["--encoder-weights", "w.pth"]])
def test_cli_flags_of_later_slices_exit(tmp_path, flag):
    """The flags of the later slices exit as segtpu's do on what they cannot
    take: ``--s2d`` for a model without an s2d mode (dilated_linknet34),
    ``--remat`` and ``--packed`` for a model without a remat or packed mode
    (linknet34), ``--model-parallel 2`` in a process that runs alone,
    ``--encoder-weights`` for a missing file."""
    if flag == ["--s2d"]:
        argv = _cli_args(tmp_path, *flag)
        argv[argv.index("linknet34")] = "dilated_linknet34"
        with pytest.raises(SystemExit, match="--s2d: model 'dilated_linknet34' has no s2d mode"):
            train_cli.main(argv)
        return
    if flag in (["--remat"], ["--packed"]):
        with pytest.raises(SystemExit,
                           match=f"{flag[0]}: model 'linknet34' has no {flag[0][2:]} mode"):
            train_cli.main(_cli_args(tmp_path, *flag))
        return
    if flag[0] == "--model-parallel":
        with pytest.raises(SystemExit, match="--model-parallel 2: .*needs 2 ranks"):
            train_cli.main(_cli_args(tmp_path, *flag))
        assert not (tmp_path / "shapes").exists()
        return
    if flag[0] == "--encoder-weights":
        with pytest.raises(FileNotFoundError, match="w.pth"):
            train_cli.main(_cli_args(tmp_path, *flag))


def test_cli_device_augs_trains_and_resumes_with_the_same_draws(tmp_path, monkeypatch):
    """``-d shapes --device-augs``: raw SHAPES loaders and the shapes
    pipeline in the step; a run of one epoch resumed with ``-r`` draws the
    unbroken two-epoch run's augmentations in its second epoch (the same
    generator seed at each step, the same augmented batches bit for bit)."""
    seeds, batches = [], []
    real = train_cli.make_train_step

    def spy(*args, augment_fn=None, **kwargs):
        def augment(g, x, y):
            seeds.append(g.initial_seed())
            assert float(x.max()) > 10.0  # raw 0-255 pixels reach the step
            out = augment_fn(g, x, y)
            batches.append(tuple(t.clone() for t in out))
            return out
        return real(*args, augment_fn=augment, **kwargs)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    args = lambda d, *extra, epochs: _cli_args(d, "--device-augs", "--seed", "3", *extra,
                                                 epochs=epochs, steps=2)
    whole = train_cli.main(args(tmp_path / "a", epochs=2))
    unbroken, unbroken_batches = list(seeds), list(batches)
    assert unbroken == [state_mod.augment_seed(3, k) for k in range(4)]
    assert len(set(unbroken)) == 4
    seeds.clear()
    batches.clear()
    train_cli.main(args(tmp_path / "b", epochs=1))
    resumed = train_cli.main(args(tmp_path / "b", "-r", epochs=2))
    assert seeds == unbroken and resumed["epoch"] == [0, 1]
    for got, want in zip(batches[2:], unbroken_batches[2:]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(math.isfinite(v) for v in whole["loss"] + whole["val_loss"] + resumed["loss"])
    # dropout is keyed by step too (ROADMAP C1): the resumed second epoch's
    # losses and metrics are the unbroken run's, bit for bit
    assert resumed == whole


def test_cli_resume_with_dropout_repeats_the_unbroken_run(straight, tmp_path):
    """LinkNet34 with its ``Dropout2d(0.5)`` on: ``-e 1`` then ``-e 2 -r``
    ends with the unbroken two-epoch run's history and weights, bit for bit
    (each step seeds dropout from (seed, step), segtpu's fold_in of
    state.step), while another seed draws other masks."""
    runs = {}
    for name, steps in (("whole", [2]), ("broken", [1, 2]), ("other", [2])):
        for epochs in steps:
            extra = ["-r"] if epochs == 2 and name == "broken" else []
            if name == "other":
                extra = ["--seed", "9", "--snapshot-every", "0"]
            runs[name] = train_cli.main(_cli_args(tmp_path / name, "--seed", "8", *extra,
                                                  epochs=epochs, steps=2))
    assert runs["broken"] == runs["whole"] and runs["whole"]["epoch"] == [0, 1]
    assert runs["other"]["loss"] != runs["whole"]["loss"]
    got, _ = load_snapshot(str(_experiment(tmp_path / "broken")[0] / "linknet34_snapshot.pth"))
    want, _ = load_snapshot(str(_experiment(tmp_path / "whole")[0] / "linknet34_snapshot.pth"))
    assert all(torch.equal(got[k], want[k]) for k in want)
    for name in runs:
        shutil.rmtree(tmp_path / name)


def test_dropout_seed_is_a_key_of_its_own():
    """(seed, step) keys: distinct per step and seed, apart from the
    augmentations' (seed, 7, step) keys and the per-rank ones."""
    keys = {state_mod.dropout_seed(s, k) for s in (0, 1) for k in range(50)}
    augs = {state_mod.augment_seed(s, k) for s in (0, 1) for k in range(50)}
    ranks = {state_mod.augment_seed(0, 3, r) for r in range(4)}
    assert len(keys) == len(augs) == 100 and not keys & augs and len(ranks) == 4


@pytest.mark.parametrize("cls", [layers.Dropout, layers.Dropout2d])
def test_dropout_ranks_draw_the_global_batch_mask(cls):
    """Two data ranks of batch 2, seeded alike, keep the rows of one
    process's mask over batch 4."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 6, 5, 5),
                                                                   dtype=np.float32))
    m = cls(0.3).train()
    torch.manual_seed(3)
    whole = m(x)
    parts = []
    for rank in range(2):
        layers.set_data_shard(m, rank, 2)
        torch.manual_seed(3)
        parts.append(m(x[2 * rank:2 * rank + 2]))
    assert torch.equal(torch.cat(parts), whole)


def test_element_dropout_scales_at_fp32_and_keeps_a_bool_mask():
    """bf16 kept values are x / (1 - p) rounded once from fp32, as torch's
    fused dropout gives them, not x times a bf16 scale; the backward keeps a
    bool mask only."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 8, 16, 16),
                                                                   dtype=np.float32))
    x = x.bfloat16().requires_grad_()
    saved = []
    torch.manual_seed(0)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.dtype) or t,
                                                  lambda t: t):
        y = layers.Dropout(0.1).train()(x)
    keep = y != 0
    assert 0.85 < keep.float().mean() < 0.95
    want = (x.detach().float() / 0.9).bfloat16()
    assert torch.equal(y.detach()[keep], want[keep])
    assert saved == [torch.bool]
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.where(keep, torch.tensor(1 / 0.9).bfloat16(), 0.0))


def test_train_step_gives_the_generator_back():
    """The step draws its dropout from the (seed, step) key and leaves the
    process's default generator as it found it."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), layers.Dropout2d(0.5),
                                layers.Dropout(0.5), torch.nn.Conv2d(4, 1, 1)).double()
    x = torch.rand(2, 3, 8, 8, dtype=torch.float64)
    y = (torch.rand(2, 1, 8, 8, dtype=torch.float64) > 0.5).double()
    losses_seen = []
    for before in (7, 8):
        net = copy.deepcopy(model)
        step = make_train_step(net, torch.optim.SGD(net.parameters(), lr=0.1),
                               losses.get_loss("bce"))
        torch.manual_seed(before)
        state = torch.get_rng_state()
        losses_seen.append([float(step(x, y, 0.1)["loss"]) for _ in range(2)])
        assert torch.equal(torch.get_rng_state(), state)
    assert losses_seen[0] == losses_seen[1]


def test_cli_device_augs_validates_raw_batches_normalised(tmp_path, monkeypatch):
    """Validation takes the raw loader's batches through the pipeline's eval
    transform: the step sees ImageNet-normalised inputs."""
    seen = []
    real = train_cli.make_eval_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)

        def eval_step(x, y):
            seen.append(float(x.abs().max()))
            return step(x, y)
        eval_step.model = step.model
        return eval_step

    monkeypatch.setattr(train_cli, "make_eval_step", spy)
    train_cli.main(_cli_args(tmp_path, "--device-augs"))
    assert seen and max(seen) < 3.0


@pytest.mark.parametrize("extra,message", [
    (["-g"], "--device-augs pipelines are RGB"),
    (["-d", "shapes-device"], "--device-augs not supported for shapes-device")])
def test_cli_device_augs_exits_as_segtpu(tmp_path, extra, message):
    """``-g`` and a dataset without a device pipeline exit before the data
    is loaded (segtpu/train_cli.py:196-204)."""
    args = _cli_args(tmp_path, "--device-augs")
    if extra[0] == "-d":
        args[args.index("-d") + 1] = extra[1]
        extra = []
    with pytest.raises(SystemExit, match=message):
        train_cli.main(args + extra)


def test_train_step_augments_in_fp32_before_the_model():
    """``make_train_step(augment_fn=...)``: the augmentation sees the raw
    fp32 batch and the generator of step k, seeded by (seed, 7, k); the
    model sees its output; ``step.step`` counts the calls."""
    model = get_model("zf_unet", device="cpu")
    calls = []

    def augment(g, x, y):
        calls.append((g.initial_seed(), x.dtype, y.dtype))
        return x * 0.0, y

    inputs = []
    model.register_forward_pre_hook(lambda m, a: inputs.append(a[0].clone()))
    opt = optim.get_optimizer("sgd", model.parameters(), 1e-3)
    step = make_train_step(model, opt, losses.get_loss("bce"), augment_fn=augment, seed=11)
    x = torch.rand(2, 3, 32, 32, dtype=torch.float64) * 255
    y = (torch.rand(2, 1, 32, 32) > 0.5).float()
    step(x, y, 1e-3)
    step.step = 7
    step(x, y, 1e-3)
    assert calls == [(state_mod.augment_seed(11, 0), torch.float32, torch.float32),
                     (state_mod.augment_seed(11, 7), torch.float32, torch.float32)]
    assert step.step == 8 and all(float(t.abs().max()) == 0.0 for t in inputs)
    assert state_mod.augment_seed(11, 7) != state_mod.augment_seed(12, 7)


def test_cli_without_a_gpu_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(args[:args.index("--device")] + args[args.index("--device") + 2:])


def test_cli_non_finite_loss_aborts_with_a_snapshot(tmp_path):
    def poison(model, args):
        with torch.no_grad():
            model.finalconv3.bias.fill_(float("nan"))

    with pytest.raises(RuntimeError, match="non-finite training loss at epoch 0"):
        train_cli.main(_cli_args(tmp_path), model_initializer=poison)
    d, _ = _experiment(tmp_path)
    _, meta = load_snapshot(str(d / "linknet34_snapshot.pth"))
    assert meta["epoch"] == 0 and meta["loss"] == float("inf")
    assert not (d / "linknet34_checkpoint.pth").exists()


def test_cli_init_torch_loads_a_state_dict_or_a_snapshot(tmp_path):
    """``--init-torch`` takes a plain state_dict or a full snapshot (its
    ``model``), strictly; ``-e 0`` trains nothing."""
    source = get_model("linknet34", device="cpu", seed=3)
    torch.save(source.state_dict(), tmp_path / "sd.pth")
    save_snapshot(str(tmp_path / "snap.pth"), source, epoch=0, loss=1.0)
    seen = []
    for f in ("sd.pth", "snap.pth"):
        train_cli.main(_cli_args(tmp_path, "--init-torch", str(tmp_path / f), epochs=0),
                       model_initializer=lambda m, a: seen.append(m.state_dict()))
    for sd in seen:
        assert all(torch.equal(sd[k], v) for k, v in source.state_dict().items())


def test_cli_profile_dir_writes_a_trace(tmp_path):
    train_cli.main(_cli_args(tmp_path, "--profile-dir", str(tmp_path / "prof")))
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000


def _event_tags(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    events = list(run_dir.rglob("events.out.tfevents.*"))
    assert len(events) == 1
    return EventAccumulator(str(events[0].parent), size_guidance={"tensors": 0}).Reload().Tags()


def test_cli_writer_writes_event_files(tmp_path, monkeypatch):
    """The CLI's writer path (``--light-logging``): per-batch and per-epoch
    scalars, the validation image grids and the PR curve of the last
    validation batch."""
    monkeypatch.chdir(tmp_path)
    args = _cli_args(tmp_path, "-sgdr", "--light-logging")
    args.remove("--no-tensorboard")
    train_cli.main(args)
    tags = _event_tags(tmp_path / "runs")
    assert {"train/batch/loss", "train/grad/global_abs_max", "train/batch/iou", "train/lr",
            "train/epoch/loss", "val/batch/accuracy", "val/epoch/iou"} <= set(tags["scalars"])
    assert {"val/image", "val/y_true", "val/y_pred"} <= set(tags["images"])
    assert "train/image" not in tags["images"] and not tags["histograms"]
    assert "val/pr_curve" in tags["tensors"]


def test_train_epoch_logs_images_and_histograms(tmp_path):
    """The train epoch's image grids and parameter histograms, on a
    one-layer model (LinkNet34's 116 histograms take seconds)."""
    from tensorboardX import SummaryWriter
    model = torch.nn.Conv2d(3, 1, 3, padding=1)
    step = make_train_step(model, optim.get_optimizer("sgd", model.parameters(), 0.1),
                           losses.get_loss("bce"), metrics.default_metrics())
    writer = SummaryWriter(str(tmp_path / "tb"))
    loader = shapes.DeviceShapesSet(4, 16).loader(2, "cpu")
    loss, scores = loop.run_train_epoch(step, loader, 0.1, 3, ["iou", "accuracy"], writer=writer,
                                        device="cpu")
    writer.close()
    assert loss.count == 2 and scores["iou"].count == 2
    tags = _event_tags(tmp_path / "tb")
    assert {"train/image", "train/y_true", "train/y_pred"} <= set(tags["images"])
    assert set(tags["histograms"]) == {"model/weight", "model/bias"}


def test_eval_step_pr_counts_and_restore_without_optimizer(tmp_path):
    """``with_pr_curve`` adds the counts of the eval logits; a snapshot
    without optimizer state loads (``load_snapshot``, ``restore_snapshot``
    with ``optimizer=None``) and refuses an optimizer to restore."""
    model = get_model("linknet34", device="cpu")
    x, y = shapes.to_nchw([shapes.ShapesDataset(2, 64)[i] for i in range(2)])
    logs = make_eval_step(model, losses.get_loss("bce"), with_pr_curve=True)(x, y)
    with torch.no_grad():
        want = metrics.pr_curve_counts(model(x), y)
    assert all(torch.equal(a, b) for a, b in zip(logs["pr_counts"], want))
    path = str(tmp_path / "old.pth")
    save_snapshot(path, model, epoch=4, loss=0.5, train_history={"epoch": [4]})
    assert "optimizer" not in torch.load(path, weights_only=False)
    assert restore_snapshot(path, model) == (5, {"epoch": [4]}, 0.5)
    with pytest.raises(KeyError, match="optimizer=None"):
        restore_snapshot(path, model, optim.get_optimizer("adam", model.parameters(), 1e-3))


OPTIONAL = ("pandas", "tqdm", "tensorboardX", "cv2", "sklearn")


def test_cli_needs_no_optional_package(tmp_path):
    """With pandas, tqdm, tensorboardX, cv2 and sklearn made unimportable,
    the CLI modules import and a ``--no-tensorboard`` run trains; none of
    them is loaded at import time or after the run."""
    code = (
        "import sys\n"
        f"BLOCK = {OPTIONAL!r}\n"
        "import importlib.machinery\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            return importlib.machinery.ModuleSpec(name, self)\n"
        "    def create_module(self, spec):\n"
        "        return None\n"
        "    def exec_module(self, module):\n"
        "        raise ImportError('blocked: ' + module.__name__)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from segtpu_torch import train_cli, train_reg_cli\n"
        "assert not [m for m in BLOCK if m in sys.modules]\n"
        f"h = train_cli.main({_cli_args(tmp_path)!r})\n"
        "assert h['epoch'] == [0]\n"
        "assert not [m for m in BLOCK if m in sys.modules], sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
