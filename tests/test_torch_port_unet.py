"""segtpu_torch's U-Net family against segtpu's: the layers it adds
(``max_pool``, ``upsample_nearest``, ``_pad_to_match``), the weight mapping,
eval and train-mode forwards of UNet, UNetABN, ZF_UNET and Afterburner, one
ZF_UNET training step, ZF_UNET's remat, the afterburner stack and its CLI,
and the train CLI on the new models.

Small: 4 filters where the model takes a width, 2 images of 32-64 pixels a
side, fp32 on the CPU, the kernels through their plain versions, torch on
two threads. Inputs are made from a seed with numpy (NHWC for segtpu, NCHW
for the port). Dropout is off on both sides where outputs are compared
(segtpu's ``DROPOUT_DISABLED``, the port's ``p = 0``).
"""

import copy
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.compat.torch_import import export_state_dict
from segtpu.models import get_model as jax_get_model
from segtpu.models import layers as jax_layers
from segtpu.models import unet as jax_unet
from segtpu.models.afterburner_stack import AfterburnerStack as JaxAfterburnerStack
from segtpu.ops import losses as jax_losses
from segtpu.ops import metrics as jax_metrics
from segtpu.train.state import TrainState
from segtpu.train.state import make_train_step as jax_make_train_step

from segtpu_torch import train_ab_cli, train_cli
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import shapes
from segtpu_torch.models import get_model
from segtpu_torch.models import layers, unet
from segtpu_torch.models.afterburner_stack import AfterburnerStack, head_frozen_mask
from segtpu_torch.ops import losses, metrics
from segtpu_torch.train import optim
from segtpu_torch.train.checkpoint import load_snapshot
from segtpu_torch.train.state import make_train_step

from torch_port_util import (_grad_errors, _grad_recorder, _jax_variables, _nchw, _nhwc,
                             _no_dropout, _numpy_dicts)
from torch_port_util import tmp_path  # noqa: F401  (removed after use)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _prefixed(state_dict, prefix):
    return {prefix + k: v for k, v in state_dict.items()}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("c, hw", [(8, (7, 9)), (128, (6, 8)), (128, (7, 9))])
def test_max_pool_matches_segtpu(c, hw, layout):
    """Forward and gradient exactly. Values from {0, 1, 2} plant ties in most
    windows, as ReLU's zeros do; the gradient must go to the first maximal
    element in row-major order. C = 128 with even H, W takes segtpu's where
    cascade, C = 8 and odd sizes its ``nn.max_pool``; odd sizes are floored."""
    rng = np.random.RandomState(c + hw[0])
    x = rng.randint(0, 3, (2,) + hw + (c,)).astype(np.float32)
    want, vjp = jax.vjp(jax_layers.max_pool, jnp.asarray(x))
    g = rng.normal(0.0, 1.0, want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g))

    xt = _nchw(x)
    if layout == "channels_last":
        xt = xt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    got = layers.max_pool(xt)
    got.backward(_nchw(g))
    assert got.shape == (2, c, hw[0] // 2, hw[1] // 2)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(want_dx))


def test_upsample_nearest_matches_segtpu():
    x = np.random.RandomState(0).normal(0.0, 1.0, (2, 5, 7, 6)).astype(np.float32)
    got = layers.upsample_nearest(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_layers.upsample_nearest(jnp.asarray(x))))


@pytest.mark.parametrize("dh, dw", [(0, 0), (1, 0), (0, 3), (2, 5)])
def test_pad_to_match_matches_segtpu(dh, dw):
    rng = np.random.RandomState(dh * 10 + dw)
    small = rng.normal(0.0, 1.0, (2, 6, 5, 3)).astype(np.float32)
    big = np.zeros((2, 6 + dh, 5 + dw, 4), np.float32)
    want = np.asarray(jax_unet._pad_to_match(jnp.asarray(small), jnp.asarray(big)))
    np.testing.assert_array_equal(_nhwc(unet._pad_to_match(_nchw(small), _nchw(big))), want)


def test_unet_pads_the_upsampled_tensor_to_the_skip():
    """At H, W not multiples of 16 the upsampled tensor is smaller than its
    skip and is padded to it, as in the reference; the logits keep the
    input's size. (segtpu pads the skip instead and raises here.)"""
    model = unet.UNet(n_filters=4)
    x = torch.from_numpy(np.random.RandomState(1).normal(0.0, 1.0, (2, 3, 40, 44))
                         .astype(np.float32))
    with torch.no_grad():
        out = model.eval()(x)
    assert out.shape == (2, 1, 40, 44) and bool(torch.isfinite(out).all())
    skip, low = torch.ones(1, 1, 5, 6), torch.full((1, 1, 2, 3), 2.0)
    padded = unet._pad_to_match(layers.upsample_nearest(low), skip)
    assert padded.shape == (1, 1, 5, 6) and float(padded[0, 0, 4].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Weights: the port's key mapping against segtpu's exporter, at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unet", "unet_abn", "zf_unet"])
def test_state_dict_from_jax_equals_export_state_dict(name):
    """segtpu's full-width tree (shapes by ``jax.eval_shape``, seeded values)
    through both mappings: the same keys and arrays; the registry's model
    loads it with ``strict=True``. num_batches_tracked, which segtpu does
    not keep, is 0 for each plain BatchNorm."""
    module = jax_get_model(name)
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                              train=False))
    rng = np.random.RandomState(0)
    tree = _numpy_dicts(jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 1.0, s.shape).astype(np.float32), tree))
    ours = state_dict_from_jax(name, tree["params"], tree["batch_stats"])
    theirs = export_state_dict(name, tree["params"], tree["batch_stats"])
    tracked = {k for k in ours if k.endswith(".num_batches_tracked")}
    assert set(ours) - tracked == set(theirs)
    assert len(tracked) == {"unet": 18, "unet_abn": 0, "zf_unet": 22}[name]
    assert all(int(ours[k]) == 0 for k in tracked)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)


# ---------------------------------------------------------------------------
# Forward parity: eval logits, train-mode logits and running statistics
# ---------------------------------------------------------------------------

def _zf_unet_case():
    module = jax_unet.ZF_UNET(filters=4)
    params, stats = _jax_variables(module, (1, 64, 64, 3))
    model = unet.ZF_UNET(filters=4)
    model.load_state_dict(state_dict_from_jax("zf_unet", params, stats))
    return module, params, stats, model, "zf_unet", (2, 64, 64, 3)


def _case(kind):
    """(segtpu module, params, stats, port model, mapping name, NHWC input
    shape) with the same weights on both sides."""
    if kind == "zf_unet":
        return _zf_unet_case()
    if kind == "afterburner":
        module = jax_unet.Afterburner()
        params, stats = _jax_variables(module, (1, 32, 32, 1))
        model = unet.Afterburner()
        model.load_state_dict(_prefixed(state_dict_from_jax("unet", params["unet"], stats["unet"]),
                                        "unet."))
        return module, params, stats, model, None, (2, 32, 32, 1)
    module = jax_unet.UNet(n_filters=4) if kind == "unet" else jax_unet.UNetABN(n_filters=4)
    params, stats = _jax_variables(module, (1, 48, 64, 3))
    model = unet.UNet(n_filters=4) if kind == "unet" else unet.UNetABN(n_filters=4)
    model.load_state_dict(state_dict_from_jax(kind, params, stats))
    return module, params, stats, model, kind, (2, 48, 64, 3)


def _port_state(name, params, stats):
    if name is None:  # the Afterburner: segtpu's UNet under "unet"
        return _prefixed(state_dict_from_jax("unet", params["unet"], stats["unet"]), "unet.")
    return state_dict_from_jax(name, params, stats)


@pytest.mark.parametrize("kind", ["unet", "unet_abn", "zf_unet", "afterburner"])
def test_forward_matches_segtpu(kind, monkeypatch):
    """Eval logits (running statistics), then train-mode logits (batch
    statistics) and the running statistics after that forward, atol 3e-4."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, params, stats, model, name, shape = _case(kind)
    x = np.random.RandomState(7).normal(0.0, 1.0, shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))
    want_train, updates = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want_state = _port_state(name, params, _numpy_dicts(updates["batch_stats"]))

    _no_dropout(model)
    with torch.no_grad():
        got_eval = model.eval()(_nchw(x))
        got_train = model.train()(_nchw(x))
    assert got_eval.dtype == torch.float32 and got_eval.shape == (2, 1) + shape[1:3]
    np.testing.assert_allclose(_nhwc(got_eval), np.asarray(want_eval), atol=3e-4)
    np.testing.assert_allclose(_nhwc(got_train), np.asarray(want_train), atol=3e-4)
    got_state = model.state_dict()
    n_stats = 0
    for key, w in want_state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_state[key].numpy(), w.numpy(), atol=3e-4, err_msg=key)
            n_stats += 1
        elif key.endswith("num_batches_tracked"):
            assert int(got_state[key]) == 1, key
    assert n_stats == 2 * {"unet": 18, "unet_abn": 18, "zf_unet": 22, "afterburner": 18}[kind]


# ---------------------------------------------------------------------------
# One ZF_UNET training step against segtpu's jitted step
# ---------------------------------------------------------------------------

LR = 0.05


def test_zf_unet_train_step_matches_segtpu(monkeypatch):
    """SGD on ``bce``, batch 2 x 64 x 64 SHAPES, against segtpu's jitted
    step run in float64 (``jax.enable_x64``). The port in fp32: the loss to
    rtol 1e-5, gradients by the card's gates (per tensor, the error over
    that tensor's max |g|: median <= 5e-3, max <= 0.1; the floor 1e-3 of the
    model's max |g| covers conv biases before a BatchNorm, whose true
    gradient is 0), running statistics and updated parameters to atol 1e-5.
    The port in float64: every gradient to 1e-6 of its scale (segtpu keeps
    its loss in fp32). segtpu's own fp32 step is further from its float64
    step at this size (median 7e-3 of the scale, max 2e-2) than the port's
    fp32 step is (median 2e-5), so the float64 step is the reference."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, params, stats, model, _, _ = _zf_unet_case()
    samples = [shapes.ShapesDataset(2, 64, seed=11)[i] for i in range(2)]
    x_nhwc, y_nhwc = np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])
    with jax.enable_x64():
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        tx = optax.inject_hyperparams(_grad_recorder)(learning_rate=LR)
        state = TrainState.create(module.apply, f64(params), f64(stats), tx)
        step = jax_make_train_step(jax_losses.get_loss("bce"), jax_metrics.default_metrics(),
                                   donate=False)
        new_state, jax_logs = step(state, (f64(x_nhwc), f64(y_nhwc)), LR, jax.random.PRNGKey(0))
        new_stats = _numpy_dicts(new_state.batch_stats)
        want_grads = state_dict_from_jax(
            "zf_unet", _numpy_dicts(new_state.opt_state.inner_state["grads"]), new_stats)
        want_after = state_dict_from_jax("zf_unet", _numpy_dicts(new_state.params), new_stats)
        floor = 1e-3 * float(jax_logs["grad_absmax"])
        jax_loss = float(jax_logs["loss"])

    _no_dropout(model)
    model64 = copy.deepcopy(model).double()
    for m, dtype, tol in ((model, torch.float32, (5e-3, 0.1)), (model64, torch.float64, (1e-6, 1e-6))):
        train_step = make_train_step(m, optim.get_optimizer("sgd", m.parameters(), LR),
                                     losses.get_loss("bce"), metrics.default_metrics())
        x, y = shapes.to_nchw(samples)
        logs = train_step(x.to(dtype), y.to(dtype), LR)
        assert float(logs["loss"]) == pytest.approx(jax_loss, rel=1e-5)
        grads = {n: p.grad.double().numpy() for n, p in m.named_parameters()}
        errs = _grad_errors(grads, {n: want_grads[n].numpy() for n in grads}, floor)
        assert errs[len(errs) // 2] <= tol[0] and errs[-1] <= tol[1], (dtype, errs[-3:])
    got = model.state_dict()
    for key, w in want_after.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 1, key
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=key)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_zf_unet_remat_equals_no_remat():
    """With remat each block runs forward twice in a training step (counted
    by hooks), yet the loss, every gradient and every buffer after one SGD
    step equal the step without it, bit for bit, dropout on: the recompute
    draws the same masks and the running statistics are updated once."""
    base = unet.ZF_UNET(filters=4)
    layers.reset_parameters(base, torch.Generator().manual_seed(3))
    x, y = shapes.to_nchw([shapes.ShapesDataset(2, 64, seed=12)[i] for i in range(2)])
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.remat = remat
        calls = []
        for m in model.modules():
            if isinstance(m, layers.BatchNormTorch):
                m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
        step = make_train_step(model, optim.get_optimizer("sgd", model.parameters(), LR),
                               losses.get_loss("bce"))
        torch.manual_seed(5)
        logs = step(x, y, LR)
        runs.append((float(logs["loss"]), {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict(), len(calls)))
    (loss0, grads0, state0, calls0), (loss1, grads1, state1, calls1) = runs
    assert (calls0, calls1) == (22, 44)
    assert loss0 == loss1
    for n, g in grads0.items():
        assert torch.equal(g, grads1[n]), n
    for k, v in state0.items():
        assert torch.equal(v, state1[k]), k
    assert all(int(v) == 1 for k, v in state1.items() if k.endswith("num_batches_tracked"))


# ---------------------------------------------------------------------------
# The afterburner stack and its trainer
# ---------------------------------------------------------------------------

def test_afterburner_stack_matches_segtpu_and_freezes_the_head(monkeypatch):
    """``afterburner(sigmoid(head(x)))`` with a ZF_UNET(4) head: eval logits
    to atol 3e-4; the trainable set is every parameter outside ``head.``."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module = JaxAfterburnerStack(head=jax_unet.ZF_UNET(filters=4))
    params, stats = _jax_variables(module, (1, 32, 32, 3))
    model = AfterburnerStack(unet.ZF_UNET(filters=4))
    model.load_state_dict({
        **_prefixed(state_dict_from_jax("zf_unet", params["head"], stats["head"]), "head."),
        **_prefixed(state_dict_from_jax("unet", params["afterburner"]["unet"],
                                        stats["afterburner"]["unet"]), "afterburner.unet.")})
    x = np.random.RandomState(8).normal(0.0, 1.0, (2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=3e-4)

    trainable = head_frozen_mask(model)
    names = {n for n, _ in model.named_parameters()}
    assert trainable == {n for n in names if n.startswith("afterburner.unet.")}
    assert len(names - trainable) == sum(1 for _ in model.head.parameters())


def _cli(exp_dir, *extra, model="linknet34", loss="bce", steps=2):
    return ["-m", model, "-d", "shapes", "-l", loss, "-o", "adam", "-lr", "1e-3", "-b", "2",
            "-p", "64", "-s", str(steps), "-e", "1", "--device", "cpu", "--no-tensorboard",
            "--seed", "0", "--experiments-dir", str(exp_dir), *extra]


def test_train_ab_cli_trains_the_afterburner_on_a_frozen_head(tmp_path, monkeypatch):
    """The train CLI writes linknet34's best checkpoint; the afterburner CLI,
    from the same working directory, finds it, loads it into the head, and
    trains: the head's parameters stay as loaded, its running statistics
    move, the afterburner's parameters move."""
    monkeypatch.chdir(tmp_path)
    train_cli.main(_cli(tmp_path / "head"))
    head_sd, _ = load_snapshot(str(next((tmp_path / "head").rglob("linknet34_checkpoint.pth"))))
    history = train_ab_cli.main(_cli(tmp_path / "ab"))
    assert history["epoch"] == [0] and math.isfinite(history["loss"][0])
    run = tmp_path / "ab" / "shapes" / "bce" / "ab_shapes_linknet34_64_rgb_bce"
    after, _ = load_snapshot(str(run / "linknet34_snapshot.pth"))
    start = train_ab_cli._model_builder(train_cli.build_arg_parser().parse_args(_cli(tmp_path)),
                                        3).state_dict()
    params = {n for n, _ in AfterburnerStack(get_model("linknet34", device="cpu")).named_parameters()}
    moved_stats = 0
    for key, value in head_sd.items():
        got = after["head." + key]
        if "head." + key in params:
            assert torch.equal(got, value), key
        elif key.endswith("running_mean"):
            moved_stats += not torch.equal(got, value)
    assert moved_stats == 48  # every BatchNorm and InPlaceABN of LinkNet34
    ab = [k for k in params if k.startswith("afterburner.")]
    assert sum(not torch.equal(after[k], start[k]) for k in ab) == len(ab)


def test_cli_zf_unet_remat_resume_repeats_the_unbroken_run(tmp_path):
    """A narrow ZF_UNET under ``--remat``, whose ``Dropout2d`` layers sit
    inside the recomputed blocks: ``-e 1`` then ``-e 2 -r`` gives the unbroken
    two-epoch run's history and weights bit for bit (dropout keyed by step,
    and ``torch.utils.checkpoint`` replays each block's masks)."""
    def narrow(args, num_channels):
        model = unet.ZF_UNET(input_channels=num_channels, filters=4)
        layers.reset_parameters(model, torch.Generator().manual_seed(2))
        return model

    runs = {}
    for name, epochs in (("whole", 2), ("broken", 1), ("broken", 2)):
        extra = ["-r"] if name == "broken" and epochs == 2 else []
        runs[name] = train_cli.main(_cli(tmp_path / name, "--remat", "--seed", "4", "-e",
                                         str(epochs), *extra, model="zf_unet",
                                         loss="bce_jaccard", steps=2), model_builder=narrow)
    assert runs["broken"] == runs["whole"] and runs["whole"]["epoch"] == [0, 1]
    got, _ = load_snapshot(str(next((tmp_path / "broken").rglob("zf_unet_snapshot.pth"))))
    want, _ = load_snapshot(str(next((tmp_path / "whole").rglob("zf_unet_snapshot.pth"))))
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("model, extra", [("zf_unet", ["--remat"]), ("unet_abn", [])])
def test_train_cli_trains_the_unet_family(tmp_path, model, extra):
    """One epoch at full width, 64 x 64: finite losses, and the best
    checkpoint's running statistics updated once per train step."""
    history = train_cli.main(_cli(tmp_path, *extra, model=model, loss="bce_jaccard", steps=1))
    assert history["epoch"] == [0]
    assert all(math.isfinite(v) for v in history["loss"] + history["val_loss"])
    sd, _ = load_snapshot(str(next(tmp_path.rglob(f"{model}_checkpoint.pth"))))
    tracked = [int(v) for k, v in sd.items() if k.endswith("num_batches_tracked")]
    assert tracked == [1] * {"zf_unet": 22, "unet_abn": 0}[model]
