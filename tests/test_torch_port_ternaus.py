"""segtpu_torch's TernausNet (UNet11, UNet16), AlbuNet and the transposed-conv
UNet against segtpu's: the weight mapping, eval and train-mode forwards,
AlbuNet's ``_cat_skip``, one AlbuNet training step with its encoder frozen,
the train CLI's ``--freeze-encoder`` and the two finetune bench configs.

UNet11, UNet16 and AlbuNet at full width (the VGG and ResNet-34 widths are
fixed), 2 images of 32-64 pixels a side; fp32 on the CPU, the kernels
through their plain versions, torch on two threads. Inputs are made from a
seed with numpy (NHWC for segtpu, NCHW for the port). Dropout is off on both
sides where outputs are compared.
"""

import copy
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.compat.encoder_weights import encoder_paths
from segtpu.compat.torch_import import export_state_dict
from segtpu.models import albunet as jax_albunet
from segtpu.models import get_model as jax_get_model
from segtpu.models import unet as jax_unet
from segtpu.ops import losses as jax_losses
from segtpu.ops import metrics as jax_metrics
from segtpu.train.state import TrainState
from segtpu.train.state import make_train_step as jax_make_train_step
from segtpu.utils import count_parameters as jax_count_parameters

from segtpu_torch import train_cli
from segtpu_torch.bench import BENCH_CONFIGS, measure_train
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import shapes
from segtpu_torch.models import ENCODER_PREFIXES, albunet, get_model, unet, without_encoder
from segtpu_torch.ops import losses, metrics
from segtpu_torch.train import optim
from segtpu_torch.train.checkpoint import load_snapshot
from segtpu_torch.train.state import make_train_step
from segtpu_torch.utils import count_parameters

from torch_port_util import _grad_errors, _jax_variables, _nchw, _nhwc, _no_dropout, _numpy_dicts
from torch_port_util import tmp_path  # noqa: F401  (removed after use)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _seeded_tree(module, shape, seed=0):
    """segtpu's full tree by ``jax.eval_shape``, each leaf N(0, 1) from a seed."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                              train=False))
    rng = np.random.RandomState(seed)
    return _numpy_dicts(jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 1.0, s.shape).astype(np.float32), tree))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unet11", "unet16"])
def test_state_dict_from_jax_equals_export_state_dict(name):
    """The same keys and arrays as segtpu's exporter; the registry's model
    loads the result with ``strict=True`` and has segtpu's parameter count."""
    tree = _seeded_tree(jax_get_model(name), (1, 64, 64, 3))
    ours = state_dict_from_jax(name, tree["params"], {})
    theirs = export_state_dict(name, tree["params"], {})
    assert set(ours) == set(theirs) and len(ours) == {"unet11": 40, "unet16": 50}[name]
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert count_parameters(model) == jax_count_parameters(tree["params"])


def test_albunet_mapping_uses_every_segtpu_leaf_once():
    """segtpu's exporter has no AlbuNet entry; the port's maps every leaf of
    segtpu's tree to one tensor: leaf k filled with the value k, each value
    turns up in exactly one tensor. ``num_batches_tracked`` is 0 for each of
    the 36 BatchNorms, and the port's model loads it with ``strict=True``."""
    tree = jax.eval_shape(lambda: jax_get_model("albunet").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tree = _numpy_dicts(jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, k, np.float32) for k, s in enumerate(leaves)]))
    sd = state_dict_from_jax("albunet", tree["params"], tree["batch_stats"])
    tracked = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(tracked) == 36 and all(int(sd[k]) == 0 for k in tracked)
    values = []
    for k, v in sd.items():
        if k not in tracked:
            assert bool((v == v.flatten()[0]).all()), k
            values.append(int(v.flatten()[0]))
    assert sorted(values) == list(range(len(leaves)))
    model = get_model("albunet", device="cpu")
    model.load_state_dict(sd, strict=True)
    assert count_parameters(model) == jax_count_parameters(tree["params"])


def test_albunet_channel_plan_matches_segtpu():
    """Each decoder conv's (out, in, kh, kw) is segtpu's kernel transposed."""
    tree = jax.eval_shape(lambda: jax_get_model("albunet").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))["params"]
    model = albunet.AlbuNet()
    for name in ("center", "dec5", "dec4", "dec3", "dec2", "dec1"):
        block = getattr(model, name).block
        kh, kw, cin, cout = tree[name]["convrelu"]["conv"]["Conv_0"]["kernel"].shape
        assert tuple(block[0].conv.weight.shape) == (cout, cin, kh, kw), name
        kh, kw, a, b = tree[name]["deconv"]["ConvTranspose_0"]["kernel"].shape
        assert tuple(block[1].weight.shape) == (b, a, kh, kw), name
    kh, kw, cin, cout = tree["dec0"]["conv"]["Conv_0"]["kernel"].shape
    assert tuple(model.dec0.conv.weight.shape) == (cout, cin, kh, kw) == (32, 32, 3, 3)
    assert tuple(model.final.weight.shape) == (1, 32, 1, 1)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("up_hw, skip_hw", [((4, 6), (4, 6)), ((6, 8), (7, 9)), ((7, 9), (6, 8)),
                                            ((6, 9), (7, 8)), ((5, 4), (8, 7))])
def test_cat_skip_matches_segtpu(up_hw, skip_hw):
    """Both tensors padded to the larger H and the larger W, whichever is
    smaller in each dimension, then ``[up, skip]``: exact."""
    rng = np.random.RandomState(sum(up_hw) + 3 * sum(skip_hw))
    up = rng.normal(0.0, 1.0, (2,) + up_hw + (3,)).astype(np.float32)
    skip = rng.normal(0.0, 1.0, (2,) + skip_hw + (5,)).astype(np.float32)
    want = np.asarray(jax_albunet._cat_skip(jnp.asarray(up), jnp.asarray(skip)))
    got = albunet._cat_skip(_nchw(up), _nchw(skip))
    assert got.shape == (2, 8, max(up_hw[0], skip_hw[0]), max(up_hw[1], skip_hw[1]))
    np.testing.assert_array_equal(_nhwc(got), want)


# ---------------------------------------------------------------------------
# Forward parity
# ---------------------------------------------------------------------------

def _case(kind):
    """(segtpu module, params, stats, port model, NHWC input shape) with the
    same weights on both sides."""
    if kind == "unet_deconv":
        module = jax_unet.UNet(n_filters=4, upsample=False)
        params, stats = _jax_variables(module, (1, 32, 48, 3))
        model = unet.UNet(n_filters=4, upsample=False)
        model.load_state_dict(state_dict_from_jax("unet", params, stats))
        return module, params, stats, model, "unet", (2, 32, 48, 3)
    shape = (2, 64, 64, 3) if kind == "albunet" else (2, 32, 32, 3)
    module = jax_get_model(kind)
    params, stats = _jax_variables(module, (1,) + shape[1:])
    model = get_model(kind, device="cpu")
    model.load_state_dict(state_dict_from_jax(kind, params, stats))
    return module, params, stats, model, kind, shape


@pytest.mark.parametrize("kind", ["unet11", "unet16", "albunet", "unet_deconv"])
def test_forward_matches_segtpu(kind, monkeypatch):
    """Eval logits (running statistics), then train-mode logits (batch
    statistics) and the running statistics after that forward, atol 3e-4.
    ``unet_deconv`` is ``UNet(upsample=False)``, the transposed-conv UNet."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, params, stats, model, name, shape = _case(kind)
    x = np.random.RandomState(7).normal(0.0, 1.0, shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))
    want_train, updates = jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                            mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want_state = state_dict_from_jax(name, params, _numpy_dicts(updates.get("batch_stats", {})))

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
    assert n_stats == 2 * {"unet11": 0, "unet16": 0, "albunet": 36, "unet_deconv": 18}[kind]


# ---------------------------------------------------------------------------
# One AlbuNet training step, encoder frozen, against segtpu's float64 step
# ---------------------------------------------------------------------------

LR = 1e-3


def _recording_adam(learning_rate):
    """optax Adam, keeping the (masked) gradients it was given in its state."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return grads, {"grads": grads}

    return optax.chain(optax.GradientTransformation(init, update), optax.adam(learning_rate))


def test_albunet_frozen_encoder_train_step_matches_segtpu(monkeypatch):
    """Adam on ``bce``, 2 x 64 x 64 SHAPES, with segtpu's trainable mask
    (``encoder_paths("albunet")``) against the port's ``ENCODER_PREFIXES``,
    against segtpu's jitted step run in float64. The frozen set is the same
    108 parameters on both sides. Port in fp32: loss rtol 1e-5; the
    trainable tensors' gradients, error over the tensor's max |g| (floor
    1e-3 of the model's max |g|), median <= 1e-5 and max <= 1e-2 (measured
    8.5e-7 and 1.1e-3: no BatchNorm lies between the loss and a trainable
    parameter); running statistics atol 1e-5. Port in float64: gradients to
    1e-6 of their scale (segtpu keeps its loss in fp32) and the updated
    parameters to atol 1e-7, 1e-4 of Adam's first step of about lr (measured
    2.2e-8, on elements whose gradient is near 0, where g / (|g| + eps)
    moves fastest); in fp32 that step is about lr * sign(g), so the
    gradients are what is gated.
    The frozen parameters' gradients are zero and their values unchanged on
    both sides; every encoder running statistic moves."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module = jax_get_model("albunet")
    params, stats = _jax_variables(module, (1, 64, 64, 3), seed=3)
    (path,), = [encoder_paths("albunet", params)]
    mask = {k: jax.tree_util.tree_map(lambda _: k != path[0], v) for k, v in params.items()}
    samples = [shapes.ShapesDataset(2, 64, seed=13)[i] for i in range(2)]
    x_nhwc, y_nhwc = np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])
    with jax.enable_x64():
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        tx = optax.inject_hyperparams(_recording_adam)(learning_rate=LR)
        state = TrainState.create(module.apply, f64(params), f64(stats), tx)
        step = jax_make_train_step(jax_losses.get_loss("bce"), jax_metrics.default_metrics(),
                                   trainable_mask=mask, donate=False)
        new_state, jax_logs = step(state, (f64(x_nhwc), f64(y_nhwc)), LR, jax.random.PRNGKey(0))
        new_stats = _numpy_dicts(new_state.batch_stats)
        want_grads = state_dict_from_jax(
            "albunet", _numpy_dicts(new_state.opt_state.inner_state[0]["grads"]), new_stats)
        want_after = state_dict_from_jax("albunet", _numpy_dicts(new_state.params), new_stats)
        floor = 1e-3 * float(jax_logs["grad_absmax"])
        jax_loss = float(jax_logs["loss"])
    before = state_dict_from_jax("albunet", params, stats)

    model = get_model("albunet", device="cpu")
    model.load_state_dict(before)
    names = [n for n, _ in model.named_parameters()]
    trainable = without_encoder("albunet", names)
    frozen = [n for n in names if n not in trainable]
    assert len(frozen) == 108 and all(n.startswith(ENCODER_PREFIXES["albunet"]) for n in frozen)
    model64 = copy.deepcopy(model).double()
    x, y = shapes.to_nchw(samples)
    for m, dtype, tol in ((model, torch.float32, (1e-5, 1e-2)),
                          (model64, torch.float64, (1e-6, 1e-6))):
        train_step = make_train_step(m, optim.get_optimizer("adam", m.parameters(), LR),
                                     losses.get_loss("bce"), metrics.default_metrics(),
                                     trainable_mask=trainable)
        logs = train_step(x.to(dtype), y.to(dtype), LR)
        assert float(logs["loss"]) == pytest.approx(jax_loss, rel=1e-5)
        grads = {n: p.grad.double().numpy() for n, p in m.named_parameters()}
        assert all(not grads[n].any() for n in frozen)
        errs = _grad_errors(grads, {n: want_grads[n].numpy() for n in trainable}, floor)
        assert errs[len(errs) // 2] <= tol[0] and errs[-1] <= tol[1], (dtype, errs[-3:])
        got = m.state_dict()
        for n in frozen:
            assert torch.equal(got[n], before[n].to(dtype)), n
        for key, w in want_after.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key].double().numpy(), w.numpy(), atol=1e-5,
                                           err_msg=key)
                assert not torch.equal(got[key].float(), before[key]), key
            elif key.endswith("num_batches_tracked"):
                assert int(got[key]) == 1, key
            elif dtype == torch.float64:
                np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-7, rtol=0,
                                           err_msg=key)
    for n in frozen:
        np.testing.assert_array_equal(want_after[n].numpy(), before[n].numpy(), err_msg=n)


# ---------------------------------------------------------------------------
# The train CLI and the bench configs
# ---------------------------------------------------------------------------

def _cli(exp_dir, model, *extra, steps=1):
    return ["-m", model, "-d", "shapes", "-l", "bce", "-o", "adam", "-lr", "1e-3", "-b", "2",
            "-p", "64", "-s", str(steps), "-e", "1", "--device", "cpu", "--no-tensorboard",
            "--seed", "0", "--experiments-dir", str(exp_dir), *extra]


@pytest.mark.parametrize("model, n_frozen", [("unet11", 16), ("albunet", 108)])
def test_train_cli_freeze_encoder(tmp_path, model, n_frozen):
    """One epoch at full width, 64 x 64: the CSV and the last .pth are
    written, every encoder parameter in the .pth equals its initial value
    and the decoder's head moved."""
    history = train_cli.main(_cli(tmp_path, model, "--freeze-encoder"))
    assert history["epoch"] == [0]
    assert all(math.isfinite(v) for v in history["loss"] + history["val_loss"])
    run = tmp_path / "shapes" / "bce" / f"shapes_{model}_64_rgb_bce"
    assert (run / f"shapes_{model}_64_rgb_bce.csv").exists()
    after, _ = load_snapshot(str(run / f"{model}_snapshot.pth"))
    initial = get_model(model, device="cpu")
    before = initial.state_dict()
    frozen = [n for n, _ in initial.named_parameters() if n.startswith(ENCODER_PREFIXES[model])]
    assert len(frozen) == n_frozen
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    assert not torch.equal(after["final.weight"], before["final.weight"])


@pytest.mark.parametrize("config", ["unet11-finetune-512", "albunet-finetune-512"])
def test_measure_train_runs_the_finetune_configs_on_cpu(config):
    cfg = dict(BENCH_CONFIGS[config], patch=64, batch_size=2, steps=1, warmup=1)
    assert cfg["freeze_encoder"]
    ips = measure_train(device="cpu", **cfg)
    assert math.isfinite(ips) and ips > 0


@pytest.mark.parametrize("name", ["unet11", "unet16", "albunet", "tiramisu57", "tiramisu67",
                                  "tiramisu103"])
def test_get_model_runs_on_cuda_unless_the_cpu_is_asked_for(name, monkeypatch):
    """The registry builds each new model on the CPU when asked, seeded and
    in eval mode; without a GPU the default device raises."""
    model = get_model(name, device="cpu", seed=4)
    assert not model.training and next(model.parameters()).device.type == "cpu"
    again = get_model(name, device="cpu", seed=4).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(name)
