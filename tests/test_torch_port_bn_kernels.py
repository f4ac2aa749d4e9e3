"""segtpu_torch's training-mode normalisation against segtpu's.

The plain versions of kernels B1 (``channel_sums_plain``) and B3
(``abn_bwd_sums_plain``), the CPU paths of their CUDA wrappers, are held
against segtpu's Pallas kernels ``_pallas_channel_sums`` and
``abn_bwd_pallas`` in interpret mode; the port's ``BNTrain`` and
``FusedABNTrain`` against segtpu's ``bn_train`` and
``fused_abn(training=True)`` under ``jax.grad``, with segtpu's XLA and
Pallas implementations; the layers' running statistics against segtpu's
modules. Inputs are made from a seed with numpy, NHWC for segtpu and NCHW for
the port.

Sums are compared with a bound relative to the sum of magnitudes of their
terms (``RTOL_SUM`` * sum |term|): the two sides add in other orders, so the
error scales with that sum and not with the result, which may cancel to
near zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models.layers import BatchNormTorch as JaxBatchNorm
from segtpu.models.layers import InPlaceABN as JaxInPlaceABN
from segtpu.ops import abn as jax_abn
from segtpu.ops import bn_alt

from segtpu_torch.models.layers import BatchNormTorch, InPlaceABN
from segtpu_torch.ops import abn, kernels

ACTS = ["leaky_relu", "elu", "none"]
SLOPE = 0.01
RTOL_SUM = 1e-5  # fp32 sums of a few thousand terms, in two different orders


def _nchw(nhwc: np.ndarray, layout: str) -> torch.Tensor:
    """The port's input for a segtpu NHWC array: [M, C], NCHW or channels_last."""
    if layout == "mc":
        return torch.from_numpy(np.ascontiguousarray(nhwc.reshape(-1, nhwc.shape[-1])))
    t = torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2)))
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _assert_sum_close(got, want, magnitude, what):
    got, want, magnitude = (np.asarray(v, np.float64) for v in (got, want, magnitude))
    bound = RTOL_SUM * magnitude + 1e-7
    err = np.abs(got - want)
    assert np.all(err <= bound), f"{what}: max err {err.max()} vs bound {bound[np.argmax(err - bound)]}"


# ---------------------------------------------------------------------------
# B1 and B3: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["mc", "nchw", "channels_last"])
@pytest.mark.parametrize("pair", [False, True])
def test_channel_sums_plain_matches_pallas(pair, layout):
    """3 x 25 x 40 = 3000 rows: not a multiple of the Pallas row tile (2048),
    so the kernel's last tile is masked; C = 37 is not a multiple of any
    vector width."""
    rng = np.random.RandomState(0)
    c = 37
    a = (rng.normal(0.5, 2.0, (3, 25, 40, c))).astype(np.float32)
    b = (rng.normal(-0.2, 1.0, (3, 25, 40, c))).astype(np.float32) if pair else None
    s_want, q_want = bn_alt._pallas_channel_sums(
        jnp.asarray(a.reshape(-1, c)), None if b is None else jnp.asarray(b.reshape(-1, c)))
    s_got, q_got = abn.channel_sums(_nchw(a, layout), None if b is None else _nchw(b, layout))
    a2, b2 = a.reshape(-1, c), (a if b is None else b).reshape(-1, c)
    _assert_sum_close(s_got.numpy(), s_want, np.abs(a2).sum(0), "sum a")
    _assert_sum_close(q_got.numpy(), q_want, np.abs(a2 * b2).sum(0), "sum a*b")


def _abn_output(rng, shape, activation):
    """An activated output z = act(y) whose pre-activation y spans both signs,
    with gamma, beta and a gradient g."""
    c = shape[-1]
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0.0, 0.3, c).astype(np.float32)
    y = (rng.normal(0.0, 1.0, shape) * gamma + beta).astype(np.float32)
    z = np.array(jax_abn._act_forward(jnp.asarray(y), activation, SLOPE))
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return z, g, gamma, beta


@pytest.mark.parametrize("layout", ["mc", "nchw"])
@pytest.mark.parametrize("activation", ACTS)
def test_abn_bwd_sums_plain_matches_pallas(activation, layout):
    """M = 1500 rows, not a multiple of the Pallas row tile (1024). ELU: the
    port inverts with log1p (segtpu's XLA path), the Pallas kernel with
    log(max(1 + z, 1e-20)); the sums stay within RTOL_SUM all the same."""
    rng = np.random.RandomState(1)
    z, g, gamma, beta = _abn_output(rng, (3, 20, 25, 24), activation)
    c = z.shape[-1]
    want = bn_alt.abn_bwd_pallas(jnp.asarray(z.reshape(-1, c)), jnp.asarray(g.reshape(-1, c)),
                                 jnp.asarray(gamma), jnp.asarray(beta), activation, SLOPE)
    edz, eydz = abn.abn_bwd_sums(_nchw(z, layout), _nchw(g, layout), torch.from_numpy(gamma),
                                 torch.from_numpy(beta), activation, SLOPE)
    zf = jnp.asarray(z.reshape(-1, c))
    dy = np.asarray(jnp.asarray(g.reshape(-1, c)) * jax_abn._act_grad_from_output(zf, activation, SLOPE))
    xhat = (np.asarray(jax_abn._act_invert(zf, activation, SLOPE)) - beta) / gamma
    _assert_sum_close(edz.numpy(), want[0], np.abs(dy).sum(0), "edz")
    _assert_sum_close(eydz.numpy(), want[1], np.abs(xhat * dy).sum(0), "eydz")


def test_channel_sums_dispatch_takes_plain_path_on_cpu():
    """A CPU tensor goes to the plain version; the kernel's launch count
    does not move."""
    kernels.reset_launch_counts()
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    got = abn.channel_sums(x)
    want = abn.channel_sums_plain(x)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert kernels.launch_counts() == {"channel_sums": 0, "abn_norm_act": 0, "abn_bwd": 0}


@pytest.mark.parametrize("fn", ["channel_sums_cuda", "abn_bwd_sums_cuda"])
def test_reduction_wrappers_refuse_cpu_tensors(fn):
    """The kernel wrappers never fall back: a CPU tensor is an error there."""
    x = torch.zeros(2, 4, 3, 3)
    args = (x, x) if fn == "channel_sums_cuda" else (x, x, torch.ones(4), torch.zeros(4),
                                                     "leaky_relu", SLOPE)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, fn)(*args)


# ---------------------------------------------------------------------------
# The autograd Functions against segtpu's custom VJPs
# ---------------------------------------------------------------------------

def _norm_inputs(seed, shape=(2, 9, 11, 24)):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.normal(0.0, 1.5, shape) + rng.normal(0.0, 1.0, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0.0, 0.5, c).astype(np.float32)
    cot = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return x, gamma, beta, cot


def _jax_fwd_grad(fn, x, gamma, beta, cot, impl):
    """(out, mean, var) of ``fn`` and the gradients of sum(out * cot) with
    respect to (x, gamma, beta), with segtpu's BN implementation ``impl``."""
    def loss(xx, gg, bb):
        out, mean, var = fn(xx, gg, bb)
        return jnp.sum(out * jnp.asarray(cot)), (out, mean, var)

    try:
        jax_abn.BN_IMPL_OVERRIDE = impl
        grads, aux = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    finally:
        jax_abn.BN_IMPL_OVERRIDE = None
    return [np.asarray(v) for v in aux], [np.asarray(v) for v in grads]


def _torch_fwd_grad(fn, x, gamma, beta, cot, layout):
    xt = _nchw(x, layout).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    out, mean, var = fn(xt, gt, bt)
    out.backward(_nchw(cot, layout))
    return ([_to_nhwc(out), mean.numpy(), var.numpy()],
            [_to_nhwc(xt.grad), gt.grad.numpy(), bt.grad.numpy()])


def _assert_fwd_grad_close(got, want):
    """Outputs and gradients to 1e-5 of their largest magnitude: fp32 on both
    sides, with the batch statistics and the backward's channel sums added in
    different orders (measured: about 3e-7)."""
    for name, g, w in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"), got[0] + got[1],
                          want[0] + want[1]):
        np.testing.assert_allclose(g, w, atol=1e-5 * float(np.abs(w).max()), rtol=0, err_msg=name)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_bn_train_matches_segtpu(impl, layout):
    x, gamma, beta, cot = _norm_inputs(2)
    want = _jax_fwd_grad(lambda xx, gg, bb: jax_abn.bn_train_stats(xx, gg, bb, eps=1e-5),
                         x, gamma, beta, cot, impl)
    got = _torch_fwd_grad(lambda xx, gg, bb: abn.bn_train(xx, gg, bb, 1e-5),
                          x, gamma, beta, cot, layout)
    _assert_fwd_grad_close(got, want)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_fused_abn_train_matches_segtpu(impl, activation):
    x, gamma, beta, cot = _norm_inputs(3)
    want = _jax_fwd_grad(
        lambda xx, gg, bb: jax_abn.fused_abn(xx, gg, bb, training=True, activation=activation,
                                             slope=SLOPE),
        x, gamma, beta, cot, impl)
    got = _torch_fwd_grad(
        lambda xx, gg, bb: abn.fused_abn(xx, gg, bb, training=True, activation=activation,
                                         slope=SLOPE),
        x, gamma, beta, cot, "channels_last")
    _assert_fwd_grad_close(got, want)


def test_fused_abn_train_saves_output_not_input():
    """The memory-saving backward keeps z, gamma, beta and var, never x."""
    x = torch.randn(2, 4, 5, 5, requires_grad=True)
    gamma = torch.ones(4, requires_grad=True)
    beta = torch.zeros(4, requires_grad=True)
    z, _, var = abn.fused_abn(x, gamma, beta, training=True)
    saved = z.grad_fn.saved_tensors
    assert len(saved) == 4
    assert saved[0].data_ptr() == z.data_ptr()
    assert not any(t.data_ptr() == x.data_ptr() for t in saved)
    assert saved[3].data_ptr() == var.data_ptr()


# ---------------------------------------------------------------------------
# The layers: running statistics against segtpu's modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bn", "abn"])
def test_layer_training_step_matches_segtpu(kind):
    """One training-mode forward: output and running statistics (momentum
    0.1, unbiased running var) against segtpu's module with
    ``mutable=["batch_stats"]``."""
    x, gamma, beta, _ = _norm_inputs(4)
    c = x.shape[-1]
    rng = np.random.RandomState(5)
    mean0 = rng.normal(0.0, 0.2, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jmod = JaxBatchNorm(c) if kind == "bn" else JaxInPlaceABN(c)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, updates = jmod.apply(variables, jnp.asarray(x), use_running_average=False,
                               mutable=["batch_stats"])

    mod = (BatchNormTorch(c) if kind == "bn" else InPlaceABN(c)).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
        mod.running_mean.copy_(torch.from_numpy(mean0))
        mod.running_var.copy_(torch.from_numpy(var0))
    got = mod(_nchw(x, "channels_last"))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=1e-5)
    stats = updates["batch_stats"]
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    if kind == "bn":
        assert int(mod.num_batches_tracked) == 1
