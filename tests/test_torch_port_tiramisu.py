"""segtpu_torch's FC-DenseNet (Tiramisu) against segtpu's: the weight
mapping, ``_center_crop`` and ``TransitionUp``, eval and train-mode forwards
of tiramisu57 and tiramisu67 at full width and of a narrow FCDenseNet, one
training step of the narrow model, per-block remat, segtpu's packed growth and ``conv_in`` rematerialisation against the
concat block in float64, the train CLI's ``--remat`` and ``--packed``, and
the ``tiramisu67-512-b4`` bench config.

Small: full-width models at 2 x 32 x 32, a narrow FCDenseNet (two down
blocks of 2 layers, growth 4, first conv 8) at 2 x 36 x 44, whose odd
half-sizes make ``TransitionUp`` crop; fp32 on the CPU, the kernels through
their plain versions, torch on two threads. segtpu's forwards are jitted
(about 3 s to compile at this size; its eager apply takes 20-35 s). Inputs
are made from a seed with numpy (NHWC for segtpu, NCHW for the port).
Dropout is off on both sides where outputs are compared.
"""

import copy
import dataclasses
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.compat.torch_import import export_state_dict
from segtpu.models import get_model as jax_get_model
from segtpu.models import tiramisu as jax_tiramisu
from segtpu.ops import losses as jax_losses
from segtpu.ops import metrics as jax_metrics
from segtpu.train.state import TrainState
from segtpu.train.state import make_train_step as jax_make_train_step
from segtpu.utils import count_parameters as jax_count_parameters

from segtpu_torch import train_cli
from segtpu_torch.bench import BENCH_CONFIGS, measure_train
from segtpu_torch.compat import jax_params
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import shapes
from segtpu_torch.models import get_model, layers, tiramisu
from segtpu_torch.ops import abn as abn_ops
from segtpu_torch.ops import losses, metrics
from segtpu_torch.train import optim
from segtpu_torch.train.checkpoint import load_snapshot
from segtpu_torch.train.state import make_train_step
from segtpu_torch.utils import count_parameters

from torch_port_util import (_grad_errors, _grad_recorder, _jax_variables, _nchw, _nhwc,
                             _no_dropout, _numpy_dicts)
from torch_port_util import _compare, _segtpu_f64_grads
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

NARROW = dict(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2, growth_rate=4,
              out_chans_first_conv=8, n_classes=1)
NARROW_ENTRIES = jax_params._entries_tiramisu((2, 2), (2, 2), 2)
N_NORMS = {"tiramisu57": 49, "tiramisu67": 60, "tiramisu103": 96, "narrow": 2 * 2 + 2 + 2 + 2 * 2}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiramisu57", "tiramisu67", "tiramisu103"])
def test_state_dict_from_jax_equals_export_state_dict(name):
    """segtpu's full tree (shapes by ``jax.eval_shape``, seeded values)
    through both mappings: the same keys and arrays, and ``num_batches_tracked``
    0 for each BatchNorm; the registry's model loads it with ``strict=True``
    and has segtpu's parameter count."""
    module = jax_get_model(name)
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                              train=False))
    rng = np.random.RandomState(0)
    tree = _numpy_dicts(jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 1.0, s.shape).astype(np.float32), tree))
    ours = state_dict_from_jax(name, tree["params"], tree["batch_stats"])
    theirs = export_state_dict(name, tree["params"], tree["batch_stats"])
    tracked = {k for k in ours if k.endswith(".num_batches_tracked")}
    assert set(ours) - tracked == set(theirs)
    assert len(tracked) == N_NORMS[name] and all(int(ours[k]) == 0 for k in tracked)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert count_parameters(model) == jax_count_parameters(tree["params"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw, crop", [((7, 9), (6, 8)), ((8, 8), (5, 7)), ((9, 6), (9, 3))])
def test_center_crop_matches_segtpu(hw, crop):
    x = np.random.RandomState(sum(hw)).normal(0.0, 1.0, (2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jax_tiramisu._center_crop(jnp.asarray(x), *crop))
    np.testing.assert_array_equal(_nhwc(tiramisu._center_crop(_nchw(x), *crop)), want)


@pytest.mark.parametrize("low, skip", [((4, 5), (9, 11)), ((5, 5), (10, 10)), ((3, 4), (6, 9))])
def test_transition_up_matches_segtpu(low, skip):
    """The transposed conv (k3, s2: 2h + 1) cropped to the skip, then
    ``[up, skip]``: shape exact, values atol 1e-5, with segtpu's weights."""
    rng = np.random.RandomState(sum(low) + sum(skip))
    x = rng.normal(0.0, 1.0, (2,) + low + (6,)).astype(np.float32)
    s = rng.normal(0.0, 1.0, (2,) + skip + (5,)).astype(np.float32)
    module = jax_tiramisu.TransitionUp(6)
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x.shape),
                                              jnp.zeros(s.shape)))
    params = _numpy_dicts(jax.tree_util.tree_map(
        lambda a: rng.uniform(-0.2, 0.2, a.shape).astype(np.float32), tree))["params"]
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(s)))
    layer = tiramisu.TransitionUp(6, 6)
    layer.load_state_dict(jax_params.state_dict_from_entries(
        [("deconv", "convTrans", ("convTrans", "ConvTranspose_0"))], params, {}))
    with torch.no_grad():
        got = layer(_nchw(x), _nchw(s))
    assert got.shape == (2, 11) + skip == (2, 11) + want.shape[1:3]
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


# ---------------------------------------------------------------------------
# Forward parity
# ---------------------------------------------------------------------------

def _case(kind):
    """(segtpu module, params, stats, port model, entries, NHWC input shape)
    with the same weights on both sides."""
    if kind == "narrow":
        module = jax_tiramisu.FCDenseNet(**NARROW)
        params, stats = _jax_variables(module, (1, 36, 44, 3))
        model = tiramisu.FCDenseNet(**NARROW)
        entries, shape = NARROW_ENTRIES, (2, 36, 44, 3)
    else:
        module = jax_get_model(kind)
        params, stats = _jax_variables(module, (1, 32, 32, 3))
        model = get_model(kind, device="cpu")
        entries, shape = jax_params._ENTRY_BUILDERS[kind](), (2, 32, 32, 3)
    model.load_state_dict(jax_params.state_dict_from_entries(entries, params, stats))
    return module, params, stats, model, entries, shape


@pytest.mark.parametrize("kind", ["tiramisu57", "tiramisu67", "narrow"])
def test_forward_matches_segtpu(kind, monkeypatch):
    """Eval logits (running statistics), then train-mode logits (batch
    statistics) and the running statistics after that forward, atol 3e-4."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, params, stats, model, entries, shape = _case(kind)
    x = np.random.RandomState(7).normal(0.0, 1.0, shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))
    want_train, updates = jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                            mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    want_state = jax_params.state_dict_from_entries(entries, params,
                                                    _numpy_dicts(updates["batch_stats"]))
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
    assert n_stats == 2 * N_NORMS[kind]


# ---------------------------------------------------------------------------
# One training step of the narrow FCDenseNet against segtpu's float64 step
# ---------------------------------------------------------------------------

LR = 0.05


def test_narrow_train_step_matches_segtpu(monkeypatch):
    """SGD on ``bce``, batch 2 x 36 x 44 SHAPES (cut from 64 x 64 samples),
    against segtpu's jitted step run in float64 (``jax.enable_x64``), as the
    ZF_UNET step test: the port in fp32, loss rtol 1e-5, gradients per
    tensor (error over max(the tensor's max |g|, 1e-3 of the model's))
    median <= 5e-3 and max <= 0.1, running statistics and updated
    parameters atol 1e-5; the port in float64, every gradient to 1e-6 of its
    scale."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, params, stats, model, entries, _ = _case("narrow")
    samples = [shapes.ShapesDataset(2, 64, seed=14)[i] for i in range(2)]
    x_nhwc = np.stack([s[0] for s in samples])[:, :36, :44]
    y_nhwc = np.stack([s[1] for s in samples])[:, :36, :44]
    with jax.enable_x64():
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        tx = optax.inject_hyperparams(_grad_recorder)(learning_rate=LR)
        state = TrainState.create(module.apply, f64(params), f64(stats), tx)
        step = jax_make_train_step(jax_losses.get_loss("bce"), jax_metrics.default_metrics(),
                                   donate=False)
        new_state, jax_logs = step(state, (f64(x_nhwc), f64(y_nhwc)), LR, jax.random.PRNGKey(0))
        new_stats = _numpy_dicts(new_state.batch_stats)
        want_grads = jax_params.state_dict_from_entries(
            entries, _numpy_dicts(new_state.opt_state.inner_state["grads"]), new_stats)
        want_after = jax_params.state_dict_from_entries(entries, _numpy_dicts(new_state.params),
                                                        new_stats)
        floor = 1e-3 * float(jax_logs["grad_absmax"])
        jax_loss = float(jax_logs["loss"])

    _no_dropout(model)
    model64 = copy.deepcopy(model).double()
    x = _nchw(x_nhwc.astype(np.float32))
    y = _nchw(y_nhwc.astype(np.float32))
    for m, dtype, tol in ((model, torch.float32, (5e-3, 0.1)), (model64, torch.float64, (1e-6, 1e-6))):
        train_step = make_train_step(m, optim.get_optimizer("sgd", m.parameters(), LR),
                                     losses.get_loss("bce"), metrics.default_metrics())
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
# remat and the options that are not ported
# ---------------------------------------------------------------------------

def test_remat_equals_no_remat():
    """With remat each dense block runs forward twice in a training step
    (counted by hooks on the BatchNorms: the 4 transition-down norms run
    once), yet the loss, every gradient and every buffer after one SGD step
    equal the step without it, bit for bit, dropout on."""
    base = tiramisu.FCDenseNet(**NARROW)
    layers.reset_parameters(base, torch.Generator().manual_seed(3))
    x, y = shapes.to_nchw([shapes.ShapesDataset(2, 32, seed=15)[i] for i in range(2)])
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
    assert (calls0, calls1) == (N_NORMS["narrow"], 2 * N_NORMS["narrow"] - 2)
    assert loss0 == loss1
    for n, g in grads0.items():
        assert torch.equal(g, grads1[n]), n
    for k, v in state0.items():
        assert torch.equal(v, state1[k]), k
    assert all(int(v) == 1 for k, v in state1.items() if k.endswith("num_batches_tracked"))


def _f64_step(model, x, **attrs):
    """One train-mode forward and backward (dropout on, torch seeded) of a
    copy of the float64 ``model`` with ``attrs`` set."""
    m = copy.deepcopy(model)
    for k, v in attrs.items():
        setattr(m, k, v)
    torch.manual_seed(3)
    y = m(x)
    (y * torch.linspace(-1, 1, y.numel(), dtype=y.dtype).view(y.shape)).sum().backward()
    return y.detach(), {n: p.grad for n, p in m.named_parameters()}, m.state_dict()


@pytest.mark.parametrize("option", [dict(packed=True), dict(remat_policy="conv_in"),
                                    dict(packed=True, remat_policy="conv_in"),
                                    dict(packed=True, remat=True)],
                         ids=["packed", "conv_in", "packed-conv_in", "packed-remat"])
def test_options_equal_the_concat_block_in_float64(option):
    """segtpu's A18 options: ``packed`` growth (one buffer per dense block)
    and ``remat_policy="conv_in"`` (the BN-ReLU chain rematerialised), alone
    and together, and packed under ``remat``: the narrow FCDenseNet's
    logits, every gradient and every running statistic equal the concat
    block's in float64 within 1e-10 relative, dropout on; running
    statistics updated once per step."""
    model = tiramisu.FCDenseNet(**NARROW).double().train()
    x = torch.from_numpy(np.random.RandomState(12).normal(0.0, 1.0, (2, 3, 36, 44)))
    (y1, g1, s1), (y0, g0, s0) = _f64_step(model, x, **option), _f64_step(model, x)
    assert float((y1 - y0).abs().max()) <= 1e-10 * float(y0.abs().max())
    floor = 1e-3 * max(float(g.abs().max()) for g in g0.values())
    for n, g in g0.items():
        assert float((g1[n] - g).abs().max()) <= 1e-10 * max(float(g.abs().max()), floor), n
    for k, v in s0.items():
        assert float((s1[k].double() - v.double()).abs().max()) <= 1e-10 * max(
            1.0, float(v.double().abs().max())), k
    assert all(int(v) == 1 for k, v in s1.items() if k.endswith("num_batches_tracked"))


A18_OPTIONS = [dict(packed=True), dict(remat_policy="conv_in"),
               dict(packed=True, remat_policy="conv_in")]
A18_IDS = ["packed", "conv_in", "packed-conv_in"]


@pytest.mark.parametrize("option", A18_OPTIONS, ids=A18_IDS)
def test_options_match_segtpu(option, monkeypatch):
    """The narrow FCDenseNet with an A18 option on both sides, on segtpu's
    seeded weights (``_compare``): eval logits, train-mode logits and every
    running statistic after that forward, atol 3e-4 in fp32, dropout off;
    then every parameter gradient in float64 against segtpu's float64
    gradients, within 1e-6 of the tensor's largest |g| (floored at 1e-3 of
    the model's largest; segtpu rounds its logits to fp32)."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module = dataclasses.replace(jax_tiramisu.FCDenseNet(**NARROW), **option)
    model = tiramisu.FCDenseNet(**NARROW, **option)
    x = np.random.RandomState(13).normal(0.0, 1.0, (2, 36, 44, 3)).astype(np.float32)
    _compare(module, model, NARROW_ENTRIES, x, N_NORMS["narrow"])

    params, stats = _jax_variables(module, (1, 36, 44, 3))
    model.load_state_dict(jax_params.state_dict_from_entries(NARROW_ENTRIES, params, stats))
    model = _no_dropout(model).double().train()
    x64 = x.astype(np.float64)
    out = model(_nchw(x64))
    w = np.linspace(-1.0, 1.0, out.numel()).reshape(_nhwc(out).shape)
    (out * _nchw(w)).sum().backward()
    want = _segtpu_f64_grads(module, NARROW_ENTRIES, params, stats, x64, w)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want.values())
    assert max(_grad_errors(got, want, floor)) <= 1e-6


def test_packed_block_reads_one_buffer():
    """Each layer of a packed block reads an alias of the block's buffer
    (its storage, its first channels), which later writes do not bump;
    each BatchNorm copies its strided prefix once (a dense input for
    B1/B2), and the last layer of a non-upsampling block gets no copy
    before the transition."""
    block = tiramisu.DenseBlock(8, 4, 3).train()
    ptrs = []
    block.layers[0].norm.register_forward_pre_hook(
        lambda mod, inp: ptrs.append(inp[0].untyped_storage().data_ptr()))
    block.layers[2].norm.register_forward_pre_hook(
        lambda mod, inp: ptrs.append(inp[0].untyped_storage().data_ptr()))
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    abn_ops._dense.copies = 0
    out = block(x, packed=True)
    assert out.shape == (2, 20, 6, 6) and ptrs[0] == ptrs[1] == out.untyped_storage().data_ptr()
    assert abn_ops._dense.copies == 3
    out.sum().backward()
    assert torch.equal(out[:, :8], x.detach()) and x.grad is not None
    # a channels_last buffer's prefix is copied to channels_last, the layout
    # the convolutions after it take
    cl = block(x.detach().contiguous(memory_format=torch.channels_last), packed=True)
    assert cl.is_contiguous(memory_format=torch.channels_last)
    prefix = cl[:, :12]
    assert not prefix.is_contiguous(memory_format=torch.channels_last)
    assert abn_ops._dense(prefix).is_contiguous(memory_format=torch.channels_last)


def test_remat_and_remat_policy_are_exclusive():
    with pytest.raises(ValueError, match="exclusive"):
        tiramisu.FCDenseNet(remat=True, remat_policy="conv_in", **NARROW)
    model = tiramisu.FCDenseNet(**NARROW)
    model.remat, model.remat_policy = True, "conv_in"
    with pytest.raises(ValueError, match="exclusive"):
        model(torch.zeros(1, 3, 32, 32))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tiramisu.FCDenseNet(remat_policy="everything", **NARROW)


def _cli(exp_dir, *extra, model="tiramisu57"):
    return ["-m", model, "-d", "shapes", "-l", "bce", "-o", "sgd", "-lr", "1e-3", "-b", "2",
            "-p", "64", "-s", "2", "-e", "1", "--device", "cpu", "--no-tensorboard",
            "--seed", "0", "--experiments-dir", str(exp_dir), *extra]


def test_train_cli_trains_tiramisu57_packed(tmp_path, monkeypatch):
    """``--packed``: one step of tiramisu57 at 64 x 64 with packed growth
    (the model the step gets has it set); the CSV is written; ``-r -e 2``
    resumes it, packed again, and its second epoch's loss is an unbroken
    two-epoch run's, bit for bit. A model without a packed mode exits with
    segtpu's message."""
    seen = []
    real = train_cli.make_train_step

    def spy(model, *args, **kwargs):
        seen.append(model.packed)
        return real(model, *args, **kwargs)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    history = train_cli.main(_cli(tmp_path, "--packed", "-s", "1"))
    assert seen == [True] and history["epoch"] == [0]
    assert all(math.isfinite(v) for v in history["loss"])
    run = tmp_path / "shapes" / "bce" / "shapes_tiramisu57_64_rgb_bce"
    assert (run / "shapes_tiramisu57_64_rgb_bce.csv").exists()
    resumed = train_cli.main(_cli(tmp_path, "--packed", "-s", "1", "-e", "2", "-r"))
    unbroken = train_cli.main(_cli(tmp_path / "unbroken", "--packed", "-s", "1", "-e", "2"))
    assert seen == [True] * 3 and resumed["epoch"][-1] == 1
    assert resumed["loss"][-1] == unbroken["loss"][-1]
    with pytest.raises(SystemExit, match="--packed: model 'zf_unet' has no packed mode"):
        train_cli.main(_cli(tmp_path / "zf", "--packed", model="zf_unet"))


def test_train_cli_trains_tiramisu57_under_remat(tmp_path):
    """One epoch of 2 steps at full width, 64 x 64, under ``--remat``: the
    CSV and the last .pth are written, the running statistics of all 49
    BatchNorms updated once per step, and the parameters moved."""
    history = train_cli.main(_cli(tmp_path, "--remat"))
    assert history["epoch"] == [0]
    assert all(math.isfinite(v) for v in history["loss"] + history["val_loss"])
    run = tmp_path / "shapes" / "bce" / "shapes_tiramisu57_64_rgb_bce"
    assert (run / "shapes_tiramisu57_64_rgb_bce.csv").exists()
    after, _ = load_snapshot(str(run / "tiramisu57_snapshot.pth"))
    tracked = [int(v) for k, v in after.items() if k.endswith("num_batches_tracked")]
    assert tracked == [2] * N_NORMS["tiramisu57"]
    before = get_model("tiramisu57", device="cpu").state_dict()
    assert not torch.equal(after["finalConv.weight"], before["finalConv.weight"])


def test_measure_train_runs_the_tiramisu_config_on_cpu():
    cfg = dict(BENCH_CONFIGS["tiramisu67-512-b4"], patch=32, batch_size=2, steps=1, warmup=1)
    ips = measure_train(device="cpu", **cfg)
    assert math.isfinite(ips) and ips > 0
