"""The port's last two model files against segtpu's on the CPU:
``ABN`` and the global pool (models/layers.py), ``IdentityResidualBlock``
and ``DenseModule`` (models/blocks.py) and ``WideResNet``
(models/wider_resnet.py), at small widths with segtpu's seeded weights
mapped by ``compat.jax_params``. Eval and train-mode outputs to 1e-4 and
every running statistic after the training forward to 1e-4 (atol) and
1e-5 (rtol); then which kernels a training step and an eval pass reach.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segtpu.models import blocks as jax_blocks
from segtpu.models import layers as jax_layers
from segtpu.models import wider_resnet as jax_wrn

from segtpu_torch.compat.jax_params import (dense_module_entries, identity_residual_entries,
                                            state_dict_from_entries, wider_resnet_entries)
from segtpu_torch.models import blocks, layers, wider_resnet
from segtpu_torch.ops import abn as abn_ops

from torch_port_util import _compare, _nchw, _nhwc

ATOL = 1e-4
torch.set_num_threads(2)


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "none"])
def test_abn_matches_segtpu(activation):
    module = jax_layers.ABN(6, activation=activation)
    x = _x((2, 5, 7, 6))
    rng = np.random.RandomState(1)
    params = {"bn": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                     "bias": rng.normal(0.0, 0.2, 6).astype(np.float32)}}
    stats = {"bn": {"mean": rng.normal(0.0, 0.2, 6).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    variables = {"params": params, "batch_stats": stats}
    model = layers.ABN(6, activation=activation)
    sd = state_dict_from_entries([("bn", "abn", ("bn",))], params, stats)
    model.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    want_eval = module.apply(variables, jnp.asarray(x), use_running_average=True)
    want_train, updates = module.apply(variables, jnp.asarray(x), use_running_average=False,
                                       mutable=["batch_stats"])
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(model.eval()(_nchw(x))), np.asarray(want_eval),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(_nhwc(model.train()(_nchw(x))), np.asarray(want_train),
                                   atol=ATOL, rtol=0)
    new = updates["batch_stats"]["bn"]
    np.testing.assert_allclose(model.running_mean.numpy(), np.asarray(new["mean"]), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(model.running_var.numpy(), np.asarray(new["var"]), atol=ATOL,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="unknown activation"):
        layers.ABN(6, activation="relu6")


def test_global_avg_pool_matches_segtpu():
    x = _x((2, 5, 7, 6))
    want = np.asarray(jax_blocks.global_avg_pool_2d(jnp.asarray(x)))
    np.testing.assert_allclose(layers.global_avg_pool_2d(_nchw(x)).numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(layers.GlobalAvgPool2d()(_nchw(x)).numpy(),
                                  blocks.global_avg_pool_2d(_nchw(x)).numpy())


RESIDUAL = [
    # (in, channels, stride, dilation, groups)
    (8, (8, 16), 2, 1, 1),     # two convs, projection (stride and width)
    (16, (8, 16), 1, 1, 1),    # two convs, identity shortcut
    (8, (8, 8, 16), 1, 2, 2),  # bottleneck, grouped and dilated 3x3, projection
    (16, (4, 8, 16), 2, 1, 1),  # bottleneck, strided projection
]


@pytest.mark.parametrize("case", range(len(RESIDUAL)))
def test_identity_residual_block_matches_segtpu(case):
    c_in, channels, stride, dilation, groups = RESIDUAL[case]
    module = jax_blocks.IdentityResidualBlock(channels, stride=stride, dilation=dilation,
                                              groups=groups)
    model = blocks.IdentityResidualBlock(c_in, channels, stride=stride, dilation=dilation,
                                         groups=groups)
    assert (model.proj_conv is None) == (case == 1)
    _compare(module, model, identity_residual_entries(len(channels)),
             _x((2, 12, 12, c_in), case), n_stats=len(channels), atol=ATOL)


def test_identity_residual_block_rejects_bad_channels():
    with pytest.raises(ValueError, match="two or three"):
        blocks.IdentityResidualBlock(8, (8,))
    with pytest.raises(ValueError, match="groups > 1"):
        blocks.IdentityResidualBlock(8, (8, 8), groups=2)


@pytest.mark.parametrize("layers_,dilation", [(3, 1), (2, 2)])
def test_dense_module_matches_segtpu(layers_, dilation):
    module = jax_blocks.DenseModule(growth=4, layers=layers_, bottleneck_factor=2,
                                    dilation=dilation)
    model = blocks.DenseModule(6, growth=4, layers=layers_, bottleneck_factor=2,
                               dilation=dilation)
    assert model.out_channels == 6 + 4 * layers_
    _compare(module, model, dense_module_entries(layers_), _x((2, 10, 10, 6), layers_),
             n_stats=2 * layers_, atol=ATOL)


@pytest.mark.parametrize("depth,widen", [(10, 2), (16, 1)])
def test_wide_resnet_matches_segtpu(depth, widen):
    module = jax_wrn.WideResNet(depth=depth, widen_factor=widen, num_classes=5)
    model = wider_resnet.WideResNet(depth=depth, widen_factor=widen, num_classes=5)
    n_bn = 2 * 3 * ((depth - 4) // 6) + 1
    _compare(module, model, wider_resnet_entries(depth), _x((2, 16, 16, 3), depth),
             n_stats=n_bn, atol=ATOL)


def test_wide_resnet_rejects_bad_depth():
    with pytest.raises(ValueError, match="6n\\+4"):
        wider_resnet.WideResNet(depth=12)


def _counting(monkeypatch):
    counts = {"channel_sums": 0, "abn_norm_act": 0}
    for name in counts:
        real = getattr(abn_ops, name)

        def counted(*args, name=name, real=real, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(abn_ops, name, counted)
    return counts


def test_wide_resnet_step_reaches_b1_and_b2_for_each_batchnorm(monkeypatch):
    """A training step of WRN-10-1 (7 BatchNorms): B1 twice (forward
    statistics, backward sums) and B2 once per BatchNorm; an eval pass runs
    neither (F.batch_norm). An ABN's eval pass is B2 with its activation."""
    counts = _counting(monkeypatch)
    model = wider_resnet.WideResNet(depth=10, widen_factor=1, num_classes=3)
    layers.reset_parameters(model, torch.Generator().manual_seed(0))
    model.train()(_nchw(_x((2, 8, 8, 3)))).sum().backward()
    assert counts == {"channel_sums": 14, "abn_norm_act": 7}
    with torch.no_grad():
        model.eval()(_nchw(_x((2, 8, 8, 3))))
    assert counts == {"channel_sums": 14, "abn_norm_act": 7}
    block = blocks.IdentityResidualBlock(4, (4, 4)).eval()
    with torch.no_grad():
        block(_nchw(_x((1, 6, 6, 4))))
    assert counts == {"channel_sums": 14, "abn_norm_act": 9}


def test_reset_parameters_draws_the_linear_head():
    a = wider_resnet.WideResNet(depth=10, widen_factor=1)
    b = wider_resnet.WideResNet(depth=10, widen_factor=1)
    for m in (a, b):
        layers.reset_parameters(m, torch.Generator().manual_seed(3))
    assert torch.equal(a.linear.weight, b.linear.weight)
    bound = 1.0 / np.sqrt(a.linear.in_features)
    assert float(a.linear.weight.detach().abs().max()) <= bound
