"""segtpu_torch's training slice against segtpu's: losses, metrics,
optimizer updates, schedules, the SHAPES data, and one LinkNet34 training
step and eval step.

Inputs are made from a seed with numpy (NHWC for segtpu, NCHW for the port);
weights come from ``tests/torch_port_util.py``. Everything runs in fp32 on
the CPU, the kernels through their plain versions.
"""

import json
import math
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.data import shapes as jax_shapes
from segtpu.ops import losses as jax_losses
from segtpu.ops import metrics as jax_metrics
from segtpu.train import optim as jax_optim
from segtpu.train.state import TrainState
from segtpu.train.state import make_eval_step as jax_make_eval_step
from segtpu.train.state import make_train_step as jax_make_train_step

from segtpu_torch import bench
from segtpu_torch.bench import BENCH_CONFIGS, measure_train
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import shapes
from segtpu_torch.ops import losses, metrics
from segtpu_torch.train import optim
from segtpu_torch.train.state import make_eval_step, make_train_step

from torch_port_util import jax_linknet34, port_linknet34

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402


def _logits_targets(seed, shape=(2, 16, 16, 1)):
    rng = np.random.RandomState(seed)
    logits = (rng.normal(0.0, 3.0, shape)).astype(np.float32)
    targets = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    return logits, targets


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# Losses and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jax_losses.LOSS_REGISTRY))
def test_loss_matches_segtpu(name):
    """Every binary loss, quirks included, to rtol 1e-5 (fp32 global sums in
    two orders; ``focal`` is a sum over 512 pixels)."""
    assert sorted(losses.LOSS_REGISTRY) == sorted(jax_losses.LOSS_REGISTRY)
    logits, targets = _logits_targets(0)
    want = float(jax_losses.get_loss(name)(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(losses.get_loss(name)(_nchw(logits), _nchw(targets)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)


def test_get_loss_rejects_unknown_name():
    with pytest.raises(ValueError):
        losses.get_loss("nope")


@pytest.mark.parametrize("name", ["jaccard_score", "pixel_accuracy", "hard_iou"])
def test_metric_matches_segtpu(name):
    logits, targets = _logits_targets(1)
    want = float(getattr(jax_metrics, name)(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(getattr(metrics, name)(_nchw(logits), _nchw(targets)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert sorted(metrics.default_metrics()) == sorted(jax_metrics.default_metrics())


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "rms", "adam"])
def test_optimizer_update_matches_optax(name):
    """Three steps on the same numpy gradients, with the learning rate
    changed between steps (a run-time value on both sides). Gradients span
    six orders of magnitude, so Adam's first step (about lr * sign(g)) is
    checked where it is most sensitive. Parameters to atol 1e-7: one fp32
    rounding of a value of order one."""
    rng = np.random.RandomState(2)
    w0 = {"a": rng.normal(0.0, 1.0, (5, 3)).astype(np.float32),
          "b": rng.normal(0.0, 1.0, 7).astype(np.float32)}
    grads = [{k: (rng.normal(0.0, 1.0, v.shape) * 10.0 ** rng.uniform(-4, 2, v.shape))
              .astype(np.float32) for k, v in w0.items()} for _ in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]

    tx = jax_optim.get_optimizer(name, lrs[0])
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = optim.get_optimizer(name, list(torch_params.values()), lrs[0])
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        optim.set_learning_rate(opt, lr)
        opt.step()
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0,
                                       atol=1e-7, err_msg=f"{name} {k}")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        optim.get_optimizer("lbfgs", [torch.nn.Parameter(torch.zeros(1))], 1e-3)


def test_schedules_match_segtpu():
    for epoch in range(0, 31, 3):
        assert optim.step_learning_rate(epoch, 1e-3) == jax_optim.step_learning_rate(epoch, 1e-3)
        assert optim.cosine_annealing_lr(epoch, 1e-3) == jax_optim.cosine_annealing_lr(epoch, 1e-3)
    assert optim.lr_finder_schedule() == jax_optim.lr_finder_schedule()
    assert math.isclose(optim.cosine_annealing_lr(10, 1e-3), 1e-8)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grayscale", [False, True])
def test_shapes_dataset_equals_segtpu(grayscale):
    """The host generator is copied: the same seed gives the same arrays,
    bit for bit."""
    ours = shapes.ShapesDataset(4, 48, seed=7, grayscale=grayscale)
    theirs = jax_shapes.ShapesDataset(4, 48, seed=7, grayscale=grayscale)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            (x1, y1), (x2, y2) = ours[i], theirs[i]
            assert x1.dtype == x2.dtype and y1.dtype == y2.dtype
            assert np.array_equal(x1, x2) and np.array_equal(y1, y2)


def test_device_shapes_batch():
    """Same distribution as segtpu's DeviceShapes, made with a torch
    Generator: NCHW shapes, a binary mask, raw values integers in 0..255
    with the ellipse brighter than the background, the normalised batch
    equal to the raw one normalised, and the seed deciding the batch."""
    raw = shapes.DeviceShapes(40, normalize=False, device="cpu")
    x, y = raw.batch(6, torch.Generator().manual_seed(3))
    assert x.shape == (6, 3, 40, 40) and y.shape == (6, 1, 40, 40)
    assert x.dtype == torch.float32 and y.dtype == torch.float32
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0} and float(y.sum()) > 0
    assert torch.equal(x, torch.round(x)) and float(x.min()) >= 0 and float(x.max()) <= 255
    for b in range(6):
        inside, outside = y[b, 0] > 0, y[b, 0] == 0
        if inside.any() and outside.any():
            # the median pixel of a region is its fill colour (salt covers <= 10%)
            assert bool((x[b][:, inside].median(dim=1).values
                         > x[b][:, outside].median(dim=1).values).all())
    xn, yn = shapes.DeviceShapes(40, device="cpu").batch(6, torch.Generator().manual_seed(3))
    mean = torch.from_numpy(shapes.IMAGENET_MEAN).view(1, 3, 1, 1)
    std = torch.from_numpy(shapes.IMAGENET_STD).view(1, 3, 1, 1)
    torch.testing.assert_close(xn, (x / 255.0 - mean) / std)
    assert torch.equal(yn, y)
    x2, _ = raw.batch(6, torch.Generator().manual_seed(4))
    assert not torch.equal(x, x2)


# ---------------------------------------------------------------------------
# One LinkNet34 training step against segtpu's make_train_step
# ---------------------------------------------------------------------------

LR = 0.05


def _grad_recorder(learning_rate):
    """Plain SGD that also keeps the gradients it was given in its state, so
    the test reads segtpu's exact gradients from the step's output."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -learning_rate * g, grads), {"grads": grads}

    return optax.GradientTransformation(init, update)


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def linknet_step():
    """segtpu's and the port's LinkNet34 after one SGD training step on the
    same 2 x 64 x 64 SHAPES batch, dropout off on both sides."""
    module, params, stats = jax_linknet34(0)
    samples = [shapes.ShapesDataset(2, 64, seed=11)[i] for i in range(2)]
    x_nhwc = np.stack([s[0] for s in samples])
    y_nhwc = np.stack([s[1] for s in samples])
    loss_fn = jax_losses.get_loss("bce_jaccard")

    tx = optax.inject_hyperparams(_grad_recorder)(learning_rate=LR)
    state = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, stats), tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
        step = jax_make_train_step(loss_fn, jax_metrics.default_metrics(), donate=False)
        new_state, jax_logs = step(state, (jnp.asarray(x_nhwc), jnp.asarray(y_nhwc)), LR,
                                   jax.random.PRNGKey(0))
    jax_logs = {k: float(v) for k, v in jax_logs.items()}
    new_stats = _numpy_tree(new_state.batch_stats)
    jax_grads = state_dict_from_jax("linknet34", _numpy_tree(new_state.opt_state.inner_state["grads"]),
                                    new_stats)
    jax_after = state_dict_from_jax("linknet34", _numpy_tree(new_state.params), new_stats)

    model = port_linknet34(params, stats)
    model.finaldrop1.p = 0.0
    opt = optim.get_optimizer("sgd", model.parameters(), LR)
    train_step = make_train_step(model, opt, losses.get_loss("bce_jaccard"),
                                 metrics.default_metrics())
    x, y = shapes.to_nchw(samples)
    logs = {k: float(v) for k, v in train_step(x, y, LR).items()}
    return dict(module=module, new_state=new_state, jax_logs=jax_logs, jax_grads=jax_grads,
                jax_after=jax_after, model=model, logs=logs, x=x, y=y,
                x_nhwc=x_nhwc, y_nhwc=y_nhwc)


def test_linknet34_train_step_logs_match_segtpu(linknet_step):
    """Loss, grad abs-max and metrics of the step, to rtol 1e-5."""
    got, want = linknet_step["logs"], linknet_step["jax_logs"]
    assert sorted(got) == sorted(want) == ["accuracy", "grad_absmax", "iou", "loss"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


def test_linknet34_train_step_gradients_match_segtpu(linknet_step):
    """Every parameter's gradient, to 2e-4 of that tensor's largest |g|.

    fp32 on both sides, but convolutions and channel sums add in different
    orders, and at 2 x 64 x 64 the deepest BatchNorms normalise over 8 values
    per channel, which amplifies rounding layer by layer: the error is near
    2e-7 of the scale for one BN/ABN layer (test_torch_port_bn_kernels.py)
    and up to about 7e-5 here. A convolution bias that feeds a BatchNorm has
    a true gradient of zero, so its |g| is rounding noise: the scale has a
    floor of 1e-3 of the model's largest gradient."""
    model, want = linknet_step["model"], linknet_step["jax_grads"]
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len([k for k in want if not k.endswith(("running_mean", "running_var",
                                                                 "num_batches_tracked"))])
    floor = 1e-3 * linknet_step["jax_logs"]["grad_absmax"]
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 2e-4 * scale, f"{name}: max err {err}, max |g| {np.abs(w).max()}"


def test_linknet34_train_step_state_matches_segtpu(linknet_step):
    """Running statistics after the step (momentum 0.1, unbiased var) and
    the SGD-updated parameters, to atol 1e-5."""
    model, want = linknet_step["model"], linknet_step["jax_after"]
    got = model.state_dict()
    n_stats = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 1, key
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=key)
        n_stats += key.endswith("running_var")
    assert n_stats == 48  # 36 BatchNorm + 12 InPlaceABN


def test_linknet34_eval_step_uses_running_stats(linknet_step):
    """After the step, the eval step (running statistics, no update) gives
    segtpu's eval-step loss and metrics, leaves the running statistics as
    they were, and differs from a forward with the batch statistics."""
    model = linknet_step["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn = losses.get_loss("bce_jaccard")
    eval_step = make_eval_step(model, loss_fn, metrics.default_metrics())
    logs = {k: float(v) for k, v in eval_step(linknet_step["x"], linknet_step["y"]).items()}
    jax_eval = jax_make_eval_step(jax_losses.get_loss("bce_jaccard"), jax_metrics.default_metrics())
    want = jax_eval(linknet_step["new_state"], (jnp.asarray(linknet_step["x_nhwc"]),
                                                jnp.asarray(linknet_step["y_nhwc"])))
    for k, v in want.items():
        assert logs[k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    model.train()
    with torch.no_grad():
        batch_stats_loss = float(loss_fn(model(linknet_step["x"]).float(), linknet_step["y"]))
    model.load_state_dict(before)
    assert batch_stats_loss != pytest.approx(logs["loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# The trainer's entry point
# ---------------------------------------------------------------------------

def test_bench_config_matches_segtpu():
    """The port's bench configs are segtpu's five training configs, with
    segtpu's default s2d form on zf_unet-512 and unet11-finetune-512."""
    train_configs = {k for k, v in jax_bench.BENCH_CONFIGS.items() if v["kind"] == "train"}
    assert set(BENCH_CONFIGS) == train_configs and len(train_configs) == 5
    for name, config in BENCH_CONFIGS.items():
        want = dict(jax_bench.BENCH_CONFIGS[name])
        assert want.pop("kind") == "train"
        assert config.get("s2d", False) == (name in ("zf_unet-512", "unet11-finetune-512"))
        assert config == want, name


@pytest.mark.parametrize("config", sorted(BENCH_CONFIGS))
@pytest.mark.parametrize("flags", [[], ["--no-s2d"]], ids=["default", "no-s2d"])
def test_bench_runs_segtpu_form_and_prints_it(config, flags, monkeypatch, capsys):
    """segtpu's bench form: s2d on zf_unet-512 and unet11-finetune-512
    unless ``--no-s2d``, normal space elsewhere; the JSON line names it."""
    seen = {}

    def fake_measure(**kwargs):
        seen.update(kwargs)
        return 1.0

    monkeypatch.setattr(bench, "measure_train", fake_measure)
    bench.main(["--config", config, "--device", "cpu"] + flags)
    line = json.loads(capsys.readouterr().out)
    s2d = config in ("zf_unet-512", "unet11-finetune-512") and not flags
    assert seen["s2d"] is s2d and line["form"] == ("s2d" if s2d else "normal")
    assert line["metric"] == f"{config} bf16 train throughput" and line["device"] == "cpu"


def test_measure_train_runs_on_cpu_when_asked():
    ips = measure_train(batch_size=2, patch=64, steps=1, warmup=1, device="cpu")
    assert math.isfinite(ips) and ips > 0
