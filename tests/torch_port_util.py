"""Shared set-up of the segtpu_torch parity tests: one segtpu LinkNet34 with
randomised normalisation parameters and running statistics, and the port's
LinkNet34 carrying the same weights; seeded segtpu trees of any module;
NHWC <-> NCHW; a gradient-recording optax SGD and the per-tensor gradient
error."""

import math

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from segtpu.models import get_model as jax_get_model

from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.models import get_model


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
        if isinstance(m, torch.nn.Dropout2d):
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
