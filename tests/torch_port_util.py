"""Shared set-up of the segtpu_torch parity tests: one segtpu LinkNet34 with
randomised normalisation parameters and running statistics, and the port's
LinkNet34 carrying the same weights; seeded segtpu trees of any module;
NHWC <-> NCHW; a gradient-recording optax SGD and the per-tensor gradient
error; the eval and train-mode forward comparison of a segtpu module and
its port (``_compare``); temporary directories that are removed when the
test or the module that made them ends (``tmp_path``, ``module_tmp``)."""

import copy
import math
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models import get_model as jax_get_model

from segtpu_torch.compat.jax_params import state_dict_from_entries, state_dict_from_jax
from segtpu_torch.models import get_model


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with its files when the test ends. A
    module that imports it overrides pytest's own: the port's CLI tests
    write LinkNet34 checkpoints with Adam state (87-262 MB each), and pytest
    keeps the directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def module_tmp(tmp_path_factory):
    """``mktemp(name)`` for a module-scoped fixture; every directory it made
    is removed when the module's tests end."""
    made = []

    def mktemp(name: str):
        made.append(tmp_path_factory.mktemp(name))
        return made[-1]

    yield mktemp
    for path in made:
        shutil.rmtree(path, ignore_errors=True)


def _randomise_norms(params, stats, rng):
    """Every BN/ABN node (a dict holding ``scale``) gets random gamma/beta and
    running mean/var, so that no normalisation is the identity."""
    for key, node in params.items():
        if not isinstance(node, dict):
            continue
        if "scale" in node:
            c = node["scale"].shape[0]
            node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            node["bias"] = rng.normal(0.0, 0.2, c).astype(np.float32)
            stats[key]["mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
            stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        else:
            _randomise_norms(node, stats.get(key, {}), rng)


def jax_linknet34(seed: int = 0):
    """(segtpu LinkNet34 module, numpy params, numpy batch_stats)."""
    module = jax_get_model("linknet34")
    init = jax.jit(lambda key, x: module.init(key, x, train=False))  # jit: 4x faster than eager
    variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    params = _numpy_dicts(variables["params"])
    stats = _numpy_dicts(variables["batch_stats"])
    _randomise_norms(params, stats, np.random.RandomState(seed + 100))
    return module, params, stats


def _numpy_dicts(tree):
    """Nested plain dicts of numpy arrays from a (frozen) flax tree."""
    if hasattr(tree, "items"):
        return {k: _numpy_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_linknet34(params, stats):
    model = get_model("linknet34", device="cpu")
    model.load_state_dict(state_dict_from_jax("linknet34", params, stats))
    return model


def jax_predict_fn(module, params, stats):
    variables = {"params": params, "batch_stats": stats}
    return lambda x: jax.nn.sigmoid(module.apply(variables, x, train=False))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_variables(module, shape, seed=0):
    """numpy (params, batch_stats) of a segtpu module for NHWC inputs of
    ``shape``: the tree's shapes from ``jax.eval_shape`` (nothing compiled),
    kernels drawn at torch's default scale U(+-1/sqrt(fan_in)), biases
    U(+-0.1), normalisations randomised."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                              train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        bound = 0.1
        if path[-1].key == "kernel":
            bound = 1.0 / math.sqrt(int(np.prod(leaf.shape[:-1])))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    tree = _numpy_dicts(jax.tree_util.tree_map_with_path(draw, tree))
    params, stats = tree["params"], tree.get("batch_stats", {})
    _randomise_norms(params, stats, np.random.RandomState(seed + 100))
    return params, stats


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


def _grad_recorder(learning_rate):
    """Plain SGD that keeps the gradients it was given in its state."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -learning_rate * g, grads), {"grads": grads}

    return optax.GradientTransformation(init, update)


def _grad_errors(got, want, floor):
    """Per tensor: max |got - want| over max(max |want|, floor)."""
    return sorted(float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), floor)
                  for n, w in want.items())


def _segtpu_f64_grads(module, entries, params, stats, x, w):
    """segtpu's parameter gradients of ``sum(logits * w)`` after one
    train-mode forward on ``x`` (NHWC numpy), run in float64
    (``jax.enable_x64``), under the port's state_dict keys as numpy."""
    with jax.enable_x64():
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa

        def loss(p):
            y, _ = module.apply({"params": p, "batch_stats": to64(stats)}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
            return (y * jnp.asarray(w)).sum()

        grads = _numpy_dicts(jax.jit(jax.grad(loss))(to64(params)))
    return {k: v.numpy() for k, v in state_dict_from_entries(entries, grads, stats).items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


ATOL = 3e-4


def _segtpu_forwards(module, variables, x):
    """segtpu's eval output, train-mode output and updated batch_stats."""
    want_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, x)
    want_train, updates = jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                            mutable=["batch_stats"]))(variables, x)
    return want_eval, want_train, _numpy_dicts(updates.get("batch_stats", {}))


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _assert_outputs(got, want, atol):
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.ndim == 2:  # a classifier's [N, classes] logits
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=0)
            continue
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=atol, rtol=0)


def _compare(module, model, entries, x, n_stats, atol=ATOL, f64=False):
    """segtpu's ``module`` and the port's ``model`` on ``x`` (NHWC numpy)
    with segtpu's seeded weights: the eval outputs, the train-mode outputs
    and every running statistic after the training forward, to ``atol``.
    Outputs may be a tuple. ``n_stats``: the BatchNorms in the mapping.
    ``f64``: the reference is segtpu run in float64 (``jax.enable_x64``),
    for modules where segtpu's own fp32 run strays further from it than
    the port's: checked here on the train-mode outputs. A float64 copy of
    the port meets it to 1e-7 (segtpu rounds a model's logits to fp32 at
    the end)."""
    params, stats = _jax_variables(module, (1,) + x.shape[1:])
    sd = state_dict_from_entries(entries, params, stats)
    model.load_state_dict(sd, strict=False)
    missing = {k for k in model.state_dict() if k not in sd}
    assert not missing, sorted(missing)[:5]
    variables = {"params": params, "batch_stats": stats}
    _no_dropout(model)
    if f64:
        with jax.enable_x64():
            to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
            want_eval, want_train, new_stats = _segtpu_forwards(
                module, to64(variables), jnp.asarray(x, jnp.float64))
        model64 = copy.deepcopy(model).double()
        with torch.no_grad():
            _assert_outputs(model64.eval()(_nchw(x).double()), want_eval, 1e-7)
            _assert_outputs(model64.train()(_nchw(x).double()), want_train, 1e-7)
    else:
        want_eval, want_train, new_stats = _segtpu_forwards(module, variables, jnp.asarray(x))
    want_state = state_dict_from_entries(entries, params, new_stats)
    with torch.no_grad():
        _assert_outputs(model.eval()(_nchw(x)), want_eval, atol)
        got_train = model.train()(_nchw(x))
        _assert_outputs(got_train, want_train, atol)
    if f64:
        segtpu_train = _segtpu_forwards(module, variables, jnp.asarray(x))[1]

        def worst(outputs):
            return max(float(np.abs(np.asarray(o, np.float64) - np.asarray(w)).max())
                       for o, w in zip(_as_tuple(outputs), _as_tuple(want_train)))
        assert worst(tuple(_nhwc(g) for g in _as_tuple(got_train))) <= worst(segtpu_train)
    got_state = model.state_dict()
    checked = 0
    for key, w in want_state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_state[key].numpy(), w.numpy(), atol=atol, rtol=1e-5,
                                       err_msg=key)
            checked += 1
    assert checked == 2 * n_stats


# ---------------------------------------------------------------------------
# segtpu's device augmentations, replayed: for a key, the per-sample
# parameters that segtpu/augment/device.py draws, as the port's applies take
# them (segtpu_torch/augment/device.py). Each replay repeats segtpu's splits
# and draws line for line, so the port's apply can be fed segtpu's values.
# ---------------------------------------------------------------------------

def _bern(key, prob, n):
    """segtpu device.py:27-28."""
    return jax.random.uniform(key, (n,)) < prob


def _params(**arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def replay_fire(key, n, prob=0.5):
    """The flips, transpose, invert and grayscale (device.py:41, 50, 59, 251,
    473): one Bernoulli draw on ``key`` itself."""
    return _params(fire=_bern(key, prob, n))


def replay_rotate90(key, n, prob=0.5):
    """device.py:68-72."""
    k1, k2 = jax.random.split(key, 2)
    fire = _bern(k1, prob, n)
    factor = jax.random.randint(k2, (n,), 0, 5) % 4
    return _params(factor=np.asarray(jnp.where(fire, factor, 0)).astype(np.int64))


def replay_shift_scale_rotate(key, n, h, w, shift_limit=0.0625, scale_limit=0.1,
                              rotate_limit=45.0, prob=0.5):
    """device.py:150-160."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    fire = _bern(k1, prob, n)
    angle = jax.random.uniform(k2, (n,), minval=-rotate_limit, maxval=rotate_limit)
    scale = jax.random.uniform(k3, (n,), minval=1 - scale_limit, maxval=1 + scale_limit)
    dx = jax.random.uniform(k4, (n,), minval=-shift_limit, maxval=shift_limit) * w
    dy = jax.random.uniform(k5, (n,), minval=-shift_limit, maxval=shift_limit) * h
    return _params(angle=jnp.where(fire, angle, 0.0), scale=jnp.where(fire, scale, 1.0),
                   dx=jnp.where(fire, dx, 0.0), dy=jnp.where(fire, dy, 0.0))


def replay_shift(key, n, limit=4.0, prob=0.5):
    """device.py:181-187."""
    k1, k2, k3 = jax.random.split(key, 3)
    fire = _bern(k1, prob, n)
    dx = jnp.round(jax.random.uniform(k2, (n,), minval=-limit, maxval=limit))
    dy = jnp.round(jax.random.uniform(k3, (n,), minval=-limit, maxval=limit))
    return _params(dx=jnp.where(fire, dx, 0.0), dy=jnp.where(fire, dy, 0.0))


def replay_crop(key, n, h, w, size):
    """device.py:198-200."""
    k1, k2 = jax.random.split(key, 2)
    i = jax.random.randint(k1, (n,), 0, h - size + 1)
    j = jax.random.randint(k2, (n,), 0, w - size + 1)
    return _params(i=np.asarray(i).astype(np.int64), j=np.asarray(j).astype(np.int64))


def replay_alpha(key, n, kind, limit, prob=0.5):
    """brightness and contrast (device.py:224-227, 235-238), saturation
    (:250-253) and the filter (:278-281)."""
    k1, k2 = jax.random.split(key, 2)
    fire = _bern(k1, prob, n)
    if kind == "filter":
        return _params(alpha=jnp.where(fire, limit * jax.random.uniform(k2, (n,)), 0.0))
    if kind == "saturation":
        alpha = 1.0 + jax.random.uniform(k2, (n,), minval=-limit, maxval=limit)
    else:
        alpha = 1.0 + limit * jax.random.uniform(k2, (n,), minval=-1, maxval=1)
    return _params(alpha=jnp.where(fire, alpha, 1.0))


def replay_shift_scale(key, n, w, limit=4, prob=0.25):
    """device.py:302-311."""
    size0 = float(w)
    size1 = size0 + 2 * limit
    k1, k2, k3, k4 = jax.random.split(key, 4)
    fire = _bern(k1, prob, n)
    size = jnp.round(jax.random.uniform(k2, (n,), minval=size0, maxval=size1))
    dx = jnp.round(jax.random.uniform(k3, (n,)) * (size1 - size))
    dy = jnp.round(jax.random.uniform(k4, (n,)) * (size1 - size))
    return _params(s=jnp.where(fire, size / size0, 1.0), dx=jnp.where(fire, dx - limit, 0.0),
                   dy=jnp.where(fire, dy - limit, 0.0))


def replay_hsv_shift(key, n, hue=(-10, 10), sat=(-25, 25), val=(-25, 25), prob=0.5):
    """device.py:368-375 (the offsets drawn as (n, 1, 1))."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    fire = _bern(k1, prob, n)[:, None, None]
    out = {}
    for name, k, (lo, hi) in (("dh", k2, hue), ("ds", k3, sat), ("dv", k4, val)):
        d = jax.random.uniform(k, (n, 1, 1), minval=lo, maxval=hi)
        out[name] = np.asarray(jnp.where(fire, d, 0.0)).reshape(n)
    return _params(**out)


def replay_dsb2018(key, n, h, w):
    """dsb2018_train_pipeline's splits and draws (device.py:510-515)."""
    k = jax.random.split(key, 4)
    return {"rotate90": replay_rotate90(k[0], n), "vflip": replay_fire(k[1], n),
            "hflip": replay_fire(k[2], n),
            "ssr": replay_shift_scale_rotate(k[3], n, h, w, rotate_limit=15.0)}


def replay_inria(key, n, h, w, grayscale=False):
    """inria_train_pipeline's splits and draws (device.py:541-547)."""
    k = jax.random.split(key, 6)
    return {"grayscale": replay_fire(k[0], n, 1.0 if grayscale else 0.5),
            "brightness": replay_alpha(k[1], n, "brightness", 0.1),
            "contrast": replay_alpha(k[2], n, "contrast", 0.1),
            "vflip": replay_fire(k[3], n), "hflip": replay_fire(k[4], n),
            "ssr": replay_shift_scale_rotate(k[5], n, h, w, rotate_limit=15.0)}


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, world: int = 2, timeout: float = RANK_TIMEOUT_S):
    """Run ``python <argv>`` as ``world`` ranks on the CPU with torchrun's
    variables set (a fresh port from the OS), each process with its own
    timeout; returns their outputs and fails with the tail of a rank's
    output when it exits non-zero."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs
