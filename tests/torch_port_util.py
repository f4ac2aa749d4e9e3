"""Shared set-up of the segtpu_torch parity tests: one segtpu LinkNet34 with
randomised normalisation parameters and running statistics, and the port's
LinkNet34 carrying the same weights."""

import numpy as np

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
