"""segtpu_torch's parallel modes on the CPU: N ranks against one process on
the same global batch, and one process against segtpu's single-device step.

Two gloo ranks (``tests/torch_port_parallel_worker.py``, started once for the
module) run LinkNet34's training step data parallel (sync BatchNorm over B1,
B2, B3's plain versions, the loss and metrics from global sums, the summed
gradients) and tensor parallel (``model_parallel=2``), the loaders' rank
slices and tile-parallel inference. One process runs the same cases alone.

Gates: in float64 (dropout on, two Adam steps) the ranks equal the one
process to 1e-10 of each tensor's scale; in fp32 (dropout off, one SGD step)
the ranks and the one process are held to segtpu's step, and the ranks to
the one process, by the repo's fp32 rule (loss rtol 1e-5; gradient errors
of median <= 5e-3 and max <= 0.1 of each tensor's max |g|, as chip_smoke.py's
parity phases). The loaders' slices put together are the
one-process batches bit for bit; tile-parallel probabilities are within
1e-4 of one process's.
"""

import importlib
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from segtpu.ops import losses as jax_losses
from segtpu.ops import metrics as jax_metrics
from segtpu.parallel import make_mesh
from segtpu.parallel.tensor import tp_param_specs
from segtpu.train.state import TrainState
from segtpu.train.state import make_train_step as jax_make_train_step

from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.data import shapes
from segtpu_torch.inference import predict_tiled
from segtpu_torch.models import get_model
from segtpu_torch.parallel import Grid, fit_data_parallel, process_slot, shard_batch
from segtpu_torch.train.state import make_predict_step

from torch_port_util import _grad_recorder, _numpy_dicts, jax_linknet34, run_ranks
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

import torch_port_parallel_worker as worker

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_parallel_worker.py")
LR_SGD = 0.05
F64_TOL = 1e-10


def _step_case(sd, x, y, dtype, model_parallel):
    f64 = dtype == torch.float64
    return dict(kind="step", state_dict=sd, x=x, y=y, dtype=dtype, dropout=f64,
                optimizer="adam" if f64 else "sgd", lr=1e-3 if f64 else LR_SGD,
                steps=2 if f64 else 1, model_parallel=model_parallel)


# --s2d with --model-parallel: narrow models whose full-resolution level
# (8 channels) tensor parallelism shards once the smallest sharded channel
# count is 8, in s2d form, float64, dropout on
S2D_NARROW = {"tp_s2d_zf_unet": ("segtpu_torch.models.unet", "ZF_UNET", dict(filters=8)),
              "tp_s2d_unet_abn": ("segtpu_torch.models.unet", "UNetABN", dict(n_filters=8))}


def _s2d_case(narrow, x, y, model_parallel):
    module_name, cls, kwargs = narrow
    torch.manual_seed(4)
    sd = getattr(importlib.import_module(module_name), cls)(**kwargs).state_dict()
    # SGD: Adam would turn the rounding noise of the zero true gradient of a
    # conv bias that feeds a BatchNorm into steps of +-lr
    return dict(_step_case(sd, x, y, torch.float64, model_parallel), narrow=narrow,
                attrs=dict(s2d=True), min_features=8, optimizer="sgd", lr=LR_SGD)


@pytest.fixture(scope="module")
def setup(module_tmp):
    module, params, stats = jax_linknet34(0)
    sd = state_dict_from_jax("linknet34", params, stats)
    samples = [shapes.ShapesDataset(4, 64, seed=11)[i] for i in range(4)]
    x, y = shapes.to_nchw(samples)
    image = np.random.RandomState(0).randint(0, 256, (120, 100, 3)).astype(np.uint8)
    cases = {}
    for dtype, tag in ((torch.float64, "64"), (torch.float32, "32")):
        cases["dp" + tag] = _step_case(sd, x, y, dtype, 1)
        cases["tp" + tag] = _step_case(sd, x, y, dtype, 2)
    for name, narrow in S2D_NARROW.items():
        cases[name] = _s2d_case(narrow, x, y, 2)
    cases["loader"] = dict(kind="loader", n=16, patch=32, batch=4, workers=(1, 4))
    cases["tile"] = dict(kind="tile", state_dict=sd, image=image, patch=64,
                         runs=((16, True), (3, False)))
    tmp = module_tmp("ranks")
    torch.save(cases, tmp / "cases.pt")
    run_ranks([WORKER, str(tmp / "cases.pt"), str(tmp)])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    shutil.rmtree(tmp)  # ≈2 GB of float64 states and moments
    one = {tag: worker._step(_step_case(sd, x, y, dtype, 1))
           for dtype, tag in ((torch.float64, "64"), (torch.float32, "32"))}
    one.update({name: worker._step(_s2d_case(narrow, x, y, 1))
                for name, narrow in S2D_NARROW.items()})
    return dict(module=module, params=params, stats=stats, sd=sd, samples=samples, x=x, y=y,
                image=image, cases=cases, ranks=ranks, one=one)


def _close(got, want, tol, what):
    """|got - want| <= tol * max(max |want|, floor) per tensor; the floor is
    1e-3 of the largest |want| of all the tensors (a conv bias that feeds a
    BatchNorm has a true gradient of zero: its |g| is rounding noise)."""
    floats = [w for w in want.values() if w.dtype != torch.long]
    floor = 1e-3 * max(float(w.abs().max()) for w in floats)
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.long:
            assert torch.equal(g, w), f"{what} {key}"
            continue
        scale = max(float(w.abs().max()), floor)
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * scale, f"{what} {key}: err {err} at scale {scale}"


@pytest.mark.parametrize("mode", ["dp", "tp"] + sorted(S2D_NARROW))
def test_ranks_equal_one_process_in_float64(setup, mode):
    """Two Adam steps with dropout on: each rank's logs, the full gradients,
    the running statistics and the updated parameters equal one process's
    on the global batch to 1e-10 of each tensor's scale. ``tp_s2d_*``:
    ``--s2d`` under ``--model-parallel 2``, two SGD steps, the s2d level's
    layers sharded (each rank holds half of their tensors and uses them
    whole)."""
    one = setup["one"]["64" if mode in ("dp", "tp") else mode]
    for rank in setup["ranks"]:
        got = rank[mode if mode in S2D_NARROW else mode + "64"]
        if mode in S2D_NARROW:
            assert any(k.startswith(("conv_224.", "inc.")) for k in got["sharded"]), mode
        for step, (g, w) in enumerate(zip(got["logs"], one["logs"])):
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=F64_TOL, abs=F64_TOL), (step, k)
        _close(got["grads"], one["grads"], F64_TOL, "grad")
        _close(got["state"], one["state"], F64_TOL, "state")
        moments = {f"{i}.{k}": v for i, s in got["optimizer"]["state"].items()
                   for k, v in s.items()}
        want = {f"{i}.{k}": v for i, s in one["optimizer"]["state"].items() for k, v in s.items()}
        assert set(moments) == set(want)
        if want:  # plain SGD keeps none
            _close(moments, want, F64_TOL, "moment")
    assert one["logs"][0]["loss"] != one["logs"][1]["loss"]


def _segtpu_step(setup):
    """segtpu's SGD step on the global batch, dropout off: its logs, its
    gradients and its state after the step as port state_dicts."""
    module, params, stats = setup["module"], setup["params"], setup["stats"]
    x_nhwc = np.stack([s[0] for s in setup["samples"]])
    y_nhwc = np.stack([s[1] for s in setup["samples"]])
    tx = optax.inject_hyperparams(_grad_recorder)(learning_rate=LR_SGD)
    state = TrainState.create(module.apply, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, stats), tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
        step = jax_make_train_step(jax_losses.get_loss("bce_jaccard"),
                                   jax_metrics.default_metrics(), donate=False)
        new_state, logs = step(state, (jnp.asarray(x_nhwc), jnp.asarray(y_nhwc)), LR_SGD,
                               jax.random.PRNGKey(0))
    new_stats = _numpy_dicts(new_state.batch_stats)
    grads = state_dict_from_jax("linknet34", _numpy_dicts(new_state.opt_state.inner_state["grads"]),
                                new_stats)
    after = state_dict_from_jax("linknet34", _numpy_dicts(new_state.params), new_stats)
    return {k: float(v) for k, v in logs.items()}, grads, after


@pytest.fixture(scope="module")
def segtpu_step(setup):
    return _segtpu_step(setup)


# the repo's fp32 rule (chip_smoke.PARITY_TOL): steps at random init are
# ill-conditioned, so the CPU's own fp32 gradients sit up to 2.2e-2 of max |g|
# from float64 for LinkNet34 (ROADMAP.md §C)
FP32 = dict(loss_rtol=1e-5, grad_median=5e-3, grad_max=0.1, grad_floor=1e-3, stats_atol=1e-5,
            stats_rtol=1e-4, params_atol=1e-7)


def _fp32_rule(got, want_logs, want_grads, want_after):
    """Loss and metrics to rtol 1e-5; per-tensor gradient errors over
    max(max |g|, 1e-3 of the model's) with median <= 5e-3 and max <= 0.1;
    running statistics to 1e-5 + 1e-4 relative; each SGD-updated parameter
    within lr times the gradient gate, plus 1e-7."""
    t = FP32
    for k, w in want_logs.items():
        assert got["logs"][0][k] == pytest.approx(w, rel=t["loss_rtol"], abs=1e-7), k
    floor = t["grad_floor"] * max(float(w.abs().max()) for w in want_grads.values())
    errs = []
    for name, g in got["grads"].items():
        w = want_grads[name].double()
        scale = max(float(w.abs().max()), floor)
        errs.append(float((g.double() - w).abs().max()) / scale)
        if name in want_after:
            gate = LR_SGD * t["grad_max"] * scale + t["params_atol"]
            err = float((got["state"][name].double() - want_after[name].double()).abs().max())
            assert err <= gate, (name, err, gate)
    errs.sort()
    assert errs[len(errs) // 2] <= t["grad_median"] and errs[-1] <= t["grad_max"], errs[-3:]
    for key, w in want_after.items():
        if key.endswith(("running_mean", "running_var")):
            err = (got["state"][key] - w).abs()
            assert bool((err <= t["stats_atol"] + t["stats_rtol"] * w.abs()).all()), key


@pytest.mark.parametrize("who", ["one", "dp", "tp"])
def test_fp32_step_is_held_to_segtpu(setup, segtpu_step, who):
    """One SGD step in fp32, dropout off, against segtpu's single-device
    step on the same weights and global batch, by the repo's fp32 rule
    (:func:`_fp32_rule`); the ranks also against one process."""
    want_logs, want_grads, want_after = segtpu_step
    one = setup["one"]["32"]
    results = [one] if who == "one" else [r[who + "32"] for r in setup["ranks"]]
    for got in results:
        _fp32_rule(got, want_logs, want_grads, want_after)
        if who != "one":
            _fp32_rule(got, one["logs"][0], one["grads"], one["state"])


def _segtpu_sharded_keys(setup):
    """The port state_dict keys whose segtpu leaves ``tp_param_specs``
    shards over a model axis of 2."""
    mesh = make_mesh(n_devices=2, model_parallel=2, devices=jax.devices("cpu"))

    def marks(tree):
        specs = tp_param_specs(tree, mesh)
        return jax.tree_util.tree_map(lambda leaf, spec: np.full(leaf.shape, spec != PartitionSpec(),
                                                                 np.float32), tree, specs)

    flags = state_dict_from_jax("linknet34", marks(setup["params"]), marks(setup["stats"]))
    return {k for k, v in flags.items() if v.dtype != torch.long and bool(v.all())}


def test_model_parallel_shards_where_segtpu_does(setup):
    """``model_parallel=2``: the sharded tensors are those segtpu's
    ``tp_param_specs`` shards; each rank holds half of each along its dim
    and Adam's moments have the shard's shape."""
    want = _segtpu_sharded_keys(setup)
    full = {n: p.shape for n, p in get_model("linknet34", device="cpu").named_parameters()}
    for rank in setup["ranks"]:
        got = rank["tp64"]
        assert set(got["sharded"]) == want and len(want) > 100
        shapes_ = got["local_shapes"]
        for name, shape in full.items():
            if name in got["sharded"]:
                d = got["sharded"][name]
                assert shapes_[name][d] * 2 == shape[d] and np.prod(shapes_[name]) * 2 == np.prod(
                    shape), name
            else:
                assert shapes_[name] == tuple(shape), name
        names = list(full)
        for i, moments in rank["tp64"]["moment_shapes"].items():
            assert moments == {"exp_avg": shapes_[names[i]], "exp_avg_sq": shapes_[names[i]]}
        local = sum(int(np.prod(s)) for s in shapes_.values())
        assert local < 0.6 * sum(int(np.prod(s)) for s in full.values())


@pytest.mark.parametrize("key", ["host1", "host4", "device"])
def test_loader_slices_make_the_one_process_batch(setup, key):
    """Each rank builds its contiguous half of every global batch; put
    together they are the one-process loader's batches, bit for bit, at -w 1
    and 4 and for ``shapes-device``, over two epochs."""
    case = dict(setup["cases"]["loader"], workers=(int(key[4:]),) if key != "device" else ())
    want = worker._loader(case)[key]
    got = [r["loader"][key] for r in setup["ranks"]]
    assert len(got[0]) == len(got[1]) == len(want) == 8
    for b, w in enumerate(want):
        for i in range(2):
            cat = (np.concatenate if key != "device" else torch.cat)([g[b][i] for g in got])
            assert (np.array_equal(cat, w[i]) if key != "device" else torch.equal(cat, w[i])), b


def test_tile_parallel_matches_one_process(setup):
    """Tile-parallel probabilities (chunks of 2 tiles with TTA; 3 rounded up
    to 4 without) within 1e-4 of one process's ``predict_tiled``."""
    model = get_model("linknet34", device="cpu")
    model.load_state_dict(setup["sd"])
    predict = make_predict_step(model)
    for b, tta in setup["cases"]["tile"]["runs"]:
        want = predict_tiled(setup["image"], predict, patch_size=64, batch_size=b, tta=tta,
                             device="cpu")
        for rank in setup["ranks"]:
            got = rank["tile"][f"b{b}_tta{int(tta)}"]
            assert got.shape == want.shape == (120, 100)
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_grid_helpers_without_a_process_group():
    """One process: the one-rank grid, the batch kept whole, the loader's
    slot (0, 1), and the largest data-parallel size that divides a batch."""
    grid = Grid()
    assert (grid.data_size, grid.data_rank, grid.model_rank, grid.is_main) == (1, 0, 0, True)
    x = torch.arange(8)
    assert torch.equal(shard_batch((x,), grid)[0], x)
    assert torch.equal(shard_batch((x,), Grid(rank=3, world=4))[0], x[6:])
    assert process_slot(8) == (0, 1, 8)
    assert process_slot(8, 1, 2) == (1, 2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        process_slot(6, 0, 4)
    assert [fit_data_parallel(b, 4) for b in (16, 6, 3, 1)] == [4, 3, 3, 1]
