"""segtpu_torch's LinkNext, SqueezeNet and DilatedLinkNet34 against segtpu's,
whole and at full width: the weight mapping, and the eval and train-mode
forwards with the running statistics (their training steps are in
``test_torch_port_zoo_steps.py``).

2 images of 64 x 64, fp32 on the CPU, the kernels through their plain
versions, torch on two threads. Weights are segtpu's, drawn from a seed
and carried across by ``state_dict_from_jax``; inputs are made from a
seed with numpy. Dropout is off on both sides.
"""

import numpy as np
import pytest
import torch

from segtpu.compat.torch_import import export_state_dict
from segtpu.models import get_model as jax_get_model
from segtpu.utils import count_parameters as jax_count_parameters

from segtpu_torch.compat.jax_params import _ENTRY_BUILDERS, state_dict_from_jax
from segtpu_torch.models import get_model
from segtpu_torch.utils import count_parameters

from torch_port_util import _compare, _jax_variables

MODELS = ["linknext", "squeezenet", "dilated_linknet34"]
N_BN = {"linknext": 45, "squeezenet": 0, "dilated_linknet34": 48}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_segtpu_dropout(monkeypatch):
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_from_jax_equals_export_state_dict(name):
    """segtpu's exporter's keys and arrays; the registry's model loads the
    result with ``strict=True`` and has segtpu's parameter count."""
    params, stats = _jax_variables(jax_get_model(name), (1, 64, 64, 3))
    ours = state_dict_from_jax(name, params, stats)
    theirs = export_state_dict(name, params, stats)
    tracked = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - tracked == set(theirs) and len(tracked) == N_BN[name]
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert count_parameters(model) == jax_count_parameters(params)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_segtpu(name):
    """Eval logits (running statistics), train-mode logits (batch
    statistics) and the running statistics after that forward, 2 x 64 x 64,
    atol 3e-4. LinkNext is held to segtpu run in float64, from which
    segtpu's own fp32 train-mode logits stray further than atol and further
    than the port's: its 4 x 4 layer4 normalises 2048 channels over 32
    rows."""
    model = get_model(name, device="cpu")
    x = np.random.RandomState(7).normal(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    _compare(jax_get_model(name), model, _ENTRY_BUILDERS[name](), x, N_BN[name],
             f64=name == "linknext")
