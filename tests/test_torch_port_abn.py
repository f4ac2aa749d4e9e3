"""segtpu_torch's eval-mode fused ABN against segtpu's.

The kernel module's plain version (the CPU path of the B2 wrapper) is held
against segtpu's Pallas kernel ``abn_norm_act_pallas`` (interpret mode on the
CPU), and the port's ``InPlaceABN`` against segtpu's with the Pallas and the
XLA implementation. Inputs are made from a seed with numpy, NHWC for segtpu
and NCHW for the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segtpu.models.layers import InPlaceABN as JaxInPlaceABN
from segtpu.ops import abn as jax_abn
from segtpu.ops import bn_alt

from segtpu_torch.models.layers import BatchNormTorch, InPlaceABN
from segtpu_torch.ops import abn, kernels

ACTS = ["leaky_relu", "elu", "none"]


def _scale_shift(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0.0, 1.0, c).astype(np.float32))


@pytest.mark.parametrize("layout", ["mc", "nchw"])
@pytest.mark.parametrize("activation", ACTS)
def test_abn_norm_act_plain_matches_pallas(activation, layout):
    """M = 1500 rows is not a multiple of the Pallas row tile (1024). ELU:
    the port uses expm1, the Pallas kernel exp - 1; both agree to 1e-6."""
    rng = np.random.RandomState(0)
    c = 48
    scale, shift = _scale_shift(rng, c)
    if layout == "mc":
        x2d = (rng.normal(0.0, 2.0, (1500, c)) + 0.3).astype(np.float32)
        x_port = torch.from_numpy(x2d)
    else:
        nhwc = (rng.normal(0.0, 2.0, (3, 25, 20, c)) + 0.3).astype(np.float32)
        x2d = nhwc.reshape(-1, c)
        x_port = torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2)))
    want = np.asarray(bn_alt.abn_norm_act_pallas(
        jnp.asarray(x2d), jnp.asarray(scale), jnp.asarray(shift), activation, 0.01))
    got = abn.abn_norm_act(x_port, torch.from_numpy(scale), torch.from_numpy(shift),
                           activation, 0.01).numpy()
    if layout == "nchw":
        got = got.transpose(0, 2, 3, 1).reshape(-1, c)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_inplace_abn_eval_matches_segtpu(impl, activation):
    rng = np.random.RandomState(1)
    c = 24
    x = (rng.normal(0.0, 1.5, (2, 9, 11, c)) + 0.2).astype(np.float32)
    gamma, beta = _scale_shift(rng, c)
    mean = rng.normal(0.0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.2, 2.0, c).astype(np.float32)
    jmod = JaxInPlaceABN(c, activation=activation, use_running_average=True)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    try:
        jax_abn.BN_IMPL_OVERRIDE = impl
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    finally:
        jax_abn.BN_IMPL_OVERRIDE = None

    mod = InPlaceABN(c, activation=activation).eval()
    mod.load_state_dict({"weight": torch.from_numpy(gamma), "bias": torch.from_numpy(beta),
                         "running_mean": torch.from_numpy(mean),
                         "running_var": torch.from_numpy(var)})
    got = mod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).detach()
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


@pytest.mark.parametrize("module", [BatchNormTorch, InPlaceABN])
def test_training_mode_raises_until_training_slice(module):
    """Named for the guard that training mode raised before the training
    slice landed. Training mode now normalises with the batch statistics
    (per-channel mean 0, variance 1 before the affine) and moves the running
    statistics towards them."""
    m = module(4).train()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0)) * 2.0 + 1.0
    y = m(x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    if module is BatchNormTorch:  # identity affine, no activation
        torch.testing.assert_close(y.mean((0, 2, 3)), torch.zeros(4), atol=1e-6, rtol=0)
        torch.testing.assert_close(y.var((0, 2, 3), unbiased=False), torch.ones(4),
                                   atol=1e-4, rtol=0)
    torch.testing.assert_close(m.running_mean, 0.1 * x.mean((0, 2, 3)))
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * x.var((0, 2, 3), unbiased=True))


def test_fused_abn_training_raises():
    """Named for the guard that ``fused_abn(training=True)`` raised before
    the training slice landed. Training mode now returns (z, batch mean,
    batch var); eval mode without running statistics is what raises."""
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(1))
    g, b = torch.ones(4), torch.zeros(4)
    z, mean, var = abn.fused_abn(x, g, b, training=True)
    assert z.shape == x.shape
    torch.testing.assert_close(mean, x.mean((0, 2, 3)))
    torch.testing.assert_close(var, x.var((0, 2, 3), unbiased=False))
    with pytest.raises(ValueError, match="running"):
        abn.fused_abn(x, g, b, training=False)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error there."""
    x = torch.zeros(2, 4, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.abn_norm_act_cuda(x, torch.ones(4), torch.zeros(4), "leaky_relu", 0.01)


@pytest.mark.parametrize("case,inner", [
    ("nchw", 35), ("channels_last", 1), ("mc", 1), ("transposed", None),
])
def test_channel_inner_layouts(case, inner):
    x = torch.zeros(2, 4, 5, 7)
    if case == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif case == "mc":
        x = torch.zeros(70, 4)
    elif case == "transposed":
        x = x.transpose(2, 3)
    if inner is None:
        with pytest.raises(ValueError, match="channels_last"):
            kernels.channel_inner(x)
    else:
        assert kernels.channel_inner(x) == inner
