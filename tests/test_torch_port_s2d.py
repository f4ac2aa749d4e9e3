"""segtpu_torch's space-to-depth (s2d) execution against segtpu's and
against its own normal space: ``ops/s2d.py`` (the layout, the kernel
expansions after the OIHW / HWIO transpose, ``blocked_perm``, the pool exits
with planted ties), the grouped statistics of ``bn_train`` / ``fused_abn``
(forward and backward, against segtpu's with ``parts``), ``Dropout2d``'s
groups, the launch plans at the s2d shapes, every model with an s2d mode
(its s2d form equals its normal form in float64 with dropout on; zf_unet's
and unet11's s2d forwards against segtpu's s2d forwards in fp32), the
registry's s2d modes and the CLIs' ``--s2d``.

Small: narrow U-Nets (4 filters), the other models at 32 x 32 or 64 x 64,
batch 2, torch on two threads; segtpu's forwards are jitted. Inputs are
made from a seed with numpy.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from segtpu.models import get_model as jax_get_model
from segtpu.models import model_names as jax_model_names
from segtpu.models import ternaus as jax_ternaus
from segtpu.models import tiramisu as jax_tiramisu
from segtpu.models import unet as jax_unet
from segtpu.ops import abn as jax_abn
from segtpu.ops import s2d as jax_s2d

from segtpu_torch import submit_cli, train_cli
from segtpu_torch.compat import jax_params
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.models import get_model, layers, model_names, ternaus, tiramisu, unet
from segtpu_torch.ops import abn, kernels, s2d

import test_torch_port_norm_act_plan as norm_act_plan_tests
import test_torch_port_reduce_plan as reduce_plan_tests
from segtpu_torch.train.state import dropout_seed, seeded_device_generator
from torch_port_util import _compare, _grad_errors, _jax_variables, _nchw, _nhwc, _no_dropout
from torch_port_util import _segtpu_f64_grads
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

NARROW_TIRAMISU = dict(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2,
                       growth_rate=4, out_chans_first_conv=8, n_classes=1)
# s2d forms vs normal forms in float64: values and gradients (floored at
# 1e-3 of the model's largest gradient, where a conv bias that feeds a
# BatchNorm has a true gradient of 0) relative to the largest magnitude
F64_RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).normal(0.0, 1.0, shape).astype(dtype)


# ---------------------------------------------------------------------------
# ops/s2d.py against segtpu/ops/s2d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 8, 2, 5)])
def test_s2d_and_d2s_match_segtpu(shape):
    """The same ``(dy, dx, c)`` channel order, bit for bit, and d2s inverts
    s2d."""
    x = _rand(shape, 1)
    got = s2d.s2d(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_s2d.s2d(jnp.asarray(x))))
    assert torch.equal(s2d.d2s(got), _nchw(x))
    np.testing.assert_array_equal(_nhwc(s2d.d2s(got)),
                                  np.asarray(jax_s2d.d2s(jax_s2d.s2d(jnp.asarray(x)))))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_s2d_kernel_matches_segtpu_and_is_the_conv(k):
    """The expanded OIHW weight is segtpu's HWIO one transposed, bit for
    bit; in float64 the s2d conv is the s2d form of the SAME conv."""
    w = _rand((k, k, 3, 5), k)  # HWIO
    got = s2d.s2d_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jax_s2d.s2d_kernel(jnp.asarray(w))))
    x = torch.from_numpy(_rand((2, 3, 8, 6), 2, np.float64))
    w64 = torch.from_numpy(w.transpose(3, 2, 0, 1).astype(np.float64))
    want = s2d.s2d(F.conv2d(x, w64, padding=k // 2))
    kp = s2d.s2d_kernel(w64)
    torch.testing.assert_close(F.conv2d(s2d.s2d(x), kp, padding=kp.shape[2] // 2), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("parts", [(("s2d", 2), ("fold", 3)), (("fold", 3), ("s2d", 2)),
                                   (("s2d", 1), ("s2d", 4))])
def test_expand_kernel_parts_matches_segtpu(parts):
    """Bit for bit after the transpose (the folded taps summed in segtpu's
    order); a ``fold`` part is the nearest upsampling of its tensor."""
    w = _rand((3, 3, 5, 4), 3)
    got = s2d.expand_kernel_parts(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), parts)
    want = jax_s2d.expand_kernel_parts(jnp.asarray(w), parts)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), np.asarray(want))
    # float64: conv over the block-wise concat == s2d(conv(concat of normal parts))
    rng = np.random.RandomState(4)
    dense, ins = [], []
    for kind, c in parts:
        if kind == "s2d":
            t = torch.from_numpy(rng.normal(size=(2, c, 8, 6)))
            dense.append(t)
            ins.append(s2d.s2d(t))
        else:
            t = torch.from_numpy(rng.normal(size=(2, c, 4, 3)))
            dense.append(layers.upsample_nearest(t))
            ins.append(t)
    w64 = torch.from_numpy(w.transpose(3, 2, 0, 1).astype(np.float64))
    kp = s2d.expand_kernel_parts(w64, parts)
    want = s2d.s2d(F.conv2d(torch.cat(dense, 1), w64, padding=1))
    torch.testing.assert_close(F.conv2d(torch.cat(ins, 1), kp, padding=1), want,
                               rtol=1e-12, atol=1e-12)


def test_deconv_s2d_kernel_matches_segtpu_and_is_the_deconv():
    """torch's ConvTranspose2d weight (I, O, 4, 4) is segtpu's transpose
    kernel [4, 4, O, I] transposed: the expanded weight matches bit for bit,
    and in float64 :func:`layers.deconv_s2d` is the s2d form of the deconv."""
    w = _rand((4, 3, 4, 4), 5)  # (I, O, kh, kw)
    got = s2d.deconv_s2d_kernel(torch.from_numpy(w))
    want = jax_s2d.deconv_s2d_kernel(jnp.asarray(w.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), np.asarray(want))
    deconv = layers.ConvTranspose2dTorch(4, 3, 4, 2, padding=1).double()
    x = torch.from_numpy(_rand((2, 4, 5, 3), 6, np.float64))
    torch.testing.assert_close(layers.deconv_s2d(deconv, x), s2d.s2d(deconv(x)),
                               rtol=1e-12, atol=1e-12)


def test_blocked_perm_d2s_parts_and_concat_match_segtpu():
    sizes = (3, 1, 2)
    assert s2d.blocked_perm(sizes) == jax_s2d.blocked_perm(sizes)
    x = _rand((2, 3, 4, 4 * sum(sizes)), 7)
    np.testing.assert_array_equal(_nhwc(s2d.d2s_parts(_nchw(x), sizes)),
                                  np.asarray(jax_s2d.d2s_parts(jnp.asarray(x), sizes)))
    a, b = _rand((2, 3, 4, 8), 8), _rand((2, 3, 4, 12), 9)
    np.testing.assert_array_equal(_nhwc(s2d.s2d_concat(_nchw(a), _nchw(b))),
                                  np.asarray(jax_s2d.s2d_concat(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(_nhwc(s2d.s2d_tile_channels(_nchw(a))),
                                  np.asarray(jax_s2d.s2d_tile_channels(jnp.asarray(a))))


def _tied(shape, seed):
    """Values on a coarse grid, half of them clipped to 0 (ReLU-like): most
    pooling windows hold ties."""
    x = np.round(np.random.RandomState(seed).normal(0.0, 1.0, shape) * 2) / 2
    return np.maximum(x, 0.0)


@pytest.mark.parametrize("exit_name, pool", [
    ("s2d_max_pool_exit", lambda t: F.max_pool2d(t, 2, 2)),
    ("s2d_max_pool3_exit", lambda t: F.max_pool2d(t, 3, 2, 1))])
def test_pool_exits_route_ties_as_max_pool2d(exit_name, pool):
    """Values and gradients of the exits, from the s2d form, equal
    ``F.max_pool2d``'s on the normal-space tensor with planted ties (the
    whole gradient to the first maximal tap), and segtpu's exits."""
    x = _tied((2, 3, 8, 6), 10)
    g = np.random.RandomState(11).normal(size=(2, 3, 4, 3))
    a = torch.from_numpy(x).requires_grad_()
    want = pool(a)
    want.backward(torch.from_numpy(g))
    b = torch.from_numpy(x).requires_grad_()
    got = getattr(s2d, exit_name)(s2d.s2d(b))
    got.backward(torch.from_numpy(g))
    assert torch.equal(got, want) and torch.equal(b.grad, a.grad)
    assert int((a.grad == 0).sum()) > a.numel() // 2  # ties were present and routed once
    fn = getattr(jax_s2d, exit_name)
    with jax.enable_x64(True):
        xj = jnp.asarray(x.transpose(0, 2, 3, 1))
        out, vjp = jax.vjp(lambda t: fn(jax_s2d.s2d(t)), xj)
        (gx,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(out))
    np.testing.assert_array_equal(_nhwc(b.grad), np.asarray(gx))


# ---------------------------------------------------------------------------
# Grouped statistics against segtpu's bn_train / fused_abn with parts
# ---------------------------------------------------------------------------

GROUPED_PARTS = [(5,), (3, 2, 2)]


def _bn_inputs(parts, seed):
    c = 4 * sum(parts)
    x = _rand((2, 3, 5, c), seed) * 1.5 + 0.4
    g = _rand((2, 3, 5, c), seed + 1)
    f = sum(parts)
    scale = np.random.RandomState(seed + 2).uniform(0.5, 1.5, f).astype(np.float32)
    bias = np.random.RandomState(seed + 3).normal(0.0, 0.3, f).astype(np.float32)
    return x, g, scale, bias


def _segtpu_vjp(fn, x, g, scale, bias):
    """segtpu's ``(y, mean, var)`` and the VJP of ``g`` through y, jitted."""
    def run(a, s, b, ga):
        out, vjp = jax.vjp(fn, a, s, b)
        return out, vjp((ga, jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))

    return jax.jit(run)(*map(jnp.asarray, (x, scale, bias, g)))


@pytest.mark.parametrize("parts", GROUPED_PARTS, ids=str)
def test_grouped_bn_train_matches_segtpu(parts):
    """y, the batch (mean, var) and dx, d_weight, d_bias of ``bn_train``
    with ``parts`` against segtpu's ``bn_train_stats`` and its VJP, fp32."""
    x, g, scale, bias = _bn_inputs(parts, 20)
    (y_j, mean_j, var_j), (dx_j, ds_j, db_j) = _segtpu_vjp(
        lambda a, s, b: jax_abn.bn_train_stats(a, s, b, eps=1e-5, parts=parts), x, g, scale, bias)
    xt = _nchw(x).requires_grad_()
    w = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y, mean, var = abn.bn_train(xt, w, b, 1e-5, parts=parts)
    y.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ds_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(db_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation", ["leaky_relu", "elu"])
@pytest.mark.parametrize("parts", GROUPED_PARTS, ids=str)
def test_grouped_fused_abn_matches_segtpu(parts, activation):
    """z, the batch (mean, var) and dx, d_gamma, d_beta of ``fused_abn``
    with ``parts`` against segtpu's, fp32; then its eval form."""
    x, g, scale, bias = _bn_inputs(parts, 30)
    kw = dict(eps=1e-5, activation=activation, slope=0.01, parts=parts)
    (z_j, mean_j, var_j), (dx_j, ds_j, db_j) = _segtpu_vjp(
        lambda a, s, b: jax_abn.fused_abn(a, s, b, training=True, **kw), x, g, scale, bias)
    xt = _nchw(x).requires_grad_()
    w = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    z, mean, var = abn.fused_abn(xt, w, b, training=True, **kw)
    z.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(z), np.asarray(z_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ds_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(db_j), rtol=1e-4, atol=1e-4)
    rm, rv = np.abs(mean_j) + 0.1, np.asarray(var_j) + 0.5
    want = jax_abn.fused_abn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             mean=jnp.asarray(rm), var=jnp.asarray(rv), training=False, **kw)
    got = abn.fused_abn(_nchw(x), w.detach(), b.detach(), mean=torch.from_numpy(np.asarray(rm)),
                        var=torch.from_numpy(np.asarray(rv)), training=False, **kw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", ["bn", "abn"])
def test_grouped_layer_equals_normal_space_in_float64(layer):
    """A BatchNorm / InPlaceABN built with ``stat_groups=4`` gives, on the
    s2d form, the s2d form of its normal-space output, the same input
    gradient and parameter gradients, and the same running statistics
    (count 4n), in float64; and in eval mode the same output."""
    x = torch.from_numpy(_rand((2, 5, 6, 4), 40, np.float64) * 2 + 0.5)
    g = torch.from_numpy(_rand((2, 5, 6, 4), 41, np.float64))
    make = layers.BatchNormTorch if layer == "bn" else layers.InPlaceABN
    runs = []
    for groups in (1, 4):
        m = make(5, stat_groups=groups).double().train()
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
        xin = x.clone().requires_grad_()
        y = s2d.d2s(m(s2d.s2d(xin))) if groups == 4 else m(xin)
        y.backward(g)
        m.eval()
        e = s2d.d2s(m(s2d.s2d(x))) if groups == 4 else m(x)
        runs.append((y.detach(), xin.grad, m.weight.grad, m.bias.grad, m.running_mean,
                     m.running_var, e.detach()))
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=F64_RTOL, atol=1e-12)


def test_dropout2d_groups_draw_the_normal_space_mask():
    """``Dropout2d(p)(x, groups=4)`` on the s2d form drops what ``groups=1``
    drops on the normal-space tensor from the same generator state."""
    drop = layers.Dropout2d(0.5).train()
    x = torch.from_numpy(_rand((3, 6, 4, 4), 50)) + 5.0
    torch.manual_seed(9)
    want = drop(x)
    torch.manual_seed(9)
    got = s2d.d2s(drop(s2d.s2d(x), groups=4))
    assert torch.equal(got, want) and 0 < int((want == 0).sum()) < want.numel()


@pytest.mark.parametrize("shard", [(0, 1), (1, 2), (2, 3)], ids=lambda s: f"rank{s[0]}of{s[1]}")
def test_dropout2d_groups_under_the_step_key_and_the_global_batch(shard):
    """Under a train step's dropout key (``seeded_device_generator`` of
    ``dropout_seed``) and a data shard, ``groups=4`` on the s2d form drops
    what ``groups=1`` drops in normal space, which is the shard's rows of
    the one-process draw over the global batch."""
    rank, size = shard
    x = torch.from_numpy(_rand((2, 6, 4, 4), 51)) + 5.0
    drop = layers.Dropout2d(0.5).train()
    drop.data_shard = shard
    key = dropout_seed(7, 3)
    with seeded_device_generator(x.device, key):
        want = drop(x)
    with seeded_device_generator(x.device, key):
        got = s2d.d2s(drop(s2d.s2d(x), groups=4))
    assert torch.equal(got, want) and 0 < int((want == 0).sum()) < want.numel()
    whole = layers.Dropout2d(0.5).train()
    with seeded_device_generator(x.device, key):
        one_process = whole(x.repeat(size, 1, 1, 1))
    assert torch.equal(want, one_process[rank * 2:(rank + 1) * 2])


# ---------------------------------------------------------------------------
# The launch plans at the s2d paths' shapes (bf16 and fp32, channels_last)
# ---------------------------------------------------------------------------

# zf_unet and unet_abn level 0 at batch 16 (zf_unet's s2d_deep level 1),
# LinkNext's stem, tiramisu67's and tiramisu57's first block and transition
# at batch 4: 4 * (48 + 16k) and 4 * (48 + 12k) channels
S2D_SHAPES = sorted({(16, 128, 256, 256), (16, 256, 128, 128), (16, 256, 256, 256)}
                    | {(4, 4 * (48 + 16 * k), 256, 256) for k in range(6)}
                    | {(4, 4 * (48 + 12 * k), 256, 256) for k in range(5)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", S2D_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_plans_take_the_s2d_shapes(shape, dtype):
    """B1/B3's ``reduce_plan`` and B2's ``norm_act_plan`` cover every element
    once and stay within the launchers' limits at each s2d shape, by the
    plan tests' own checks."""
    case = (shape, "channels_last", True)
    reduce_plan_tests.test_reduce_plan_covers_every_element_once(case, dtype, 132)
    reduce_plan_tests.test_reduce_plan_within_limits(case, dtype, 132)
    case = (shape, "channels_last")
    norm_act_plan_tests.test_norm_act_plan_covers_every_element_once(case, dtype, True, 132)
    norm_act_plan_tests.test_norm_act_plan_within_limits(case, dtype, True, 132)


# ---------------------------------------------------------------------------
# Models: the s2d form against the normal form (float64) and segtpu (fp32)
# ---------------------------------------------------------------------------

def _step(model, x, **attrs):
    """One train-mode forward and backward of a copy of ``model`` with
    ``attrs`` set, dropout on (torch seeded): (output, grads, state)."""
    m = copy.deepcopy(model)
    for k, v in attrs.items():
        setattr(m, k, v)
    torch.manual_seed(1)
    y = m(x)
    (y * torch.linspace(-1, 1, y.numel(), dtype=y.dtype).view(y.shape)).sum().backward()
    return y.detach(), {n: p.grad for n, p in m.named_parameters()}, m.state_dict()


def _assert_same_step(got, want):
    (y1, g1, s1), (y0, g0, s0) = got, want
    assert y1.shape == y0.shape
    assert float((y1 - y0).abs().max()) <= F64_RTOL * float(y0.abs().max())
    floor = 1e-3 * max(float(g.abs().max()) for g in g0.values())
    for n, g in g0.items():
        assert float((g1[n] - g).abs().max()) <= F64_RTOL * max(float(g.abs().max()), floor), n
    for k, v in s0.items():
        assert float((s1[k].double() - v.double()).abs().max()) <= F64_RTOL * max(
            1.0, float(v.double().abs().max())), k


S2D_MODELS = {
    "zf_unet": (lambda: unet.ZF_UNET(filters=4), 64, {}),
    "zf_unet_deep": (lambda: unet.ZF_UNET(filters=4), 64, dict(s2d_deep=True)),
    "unet": (lambda: unet.UNet(n_filters=4), 48, {}),
    "unet_deep": (lambda: unet.UNet(n_filters=4), 48, dict(s2d_deep=True)),
    "unet_abn": (lambda: unet.UNetABN(n_filters=4), 48, {}),
    "unet11": (lambda: get_model("unet11", device="cpu"), 32, {}),
    "unet16": (lambda: get_model("unet16", device="cpu"), 32, {}),
    "linknet34": (lambda: get_model("linknet34", device="cpu"), 64, {}),
    "squeezenet": (lambda: get_model("squeezenet", device="cpu"), 32, {}),
    "linknext": (lambda: get_model("linknext", device="cpu"), 32, {}),
    "fcdensenet": (lambda: tiramisu.FCDenseNet(**NARROW_TIRAMISU), 32, {}),
}


@pytest.mark.parametrize("name", sorted(S2D_MODELS))
def test_s2d_form_equals_normal_form_in_float64(name):
    """Logits, every gradient and every running statistic of one train-mode
    step with dropout on: the s2d form against the normal form of the same
    float64 model, within 1e-10 relative (LinkNet34's s2d head runs: 65 x 65
    after its transposed conv)."""
    make, side, extra = S2D_MODELS[name]
    model = make().double().train()
    x = torch.from_numpy(_rand((2, 3, side, side), 60, np.float64))
    _assert_same_step(_step(model, x, s2d=True, **extra), _step(model, x))


def _segtpu_s2d_case(kind):
    if kind == "zf_unet":
        module = jax_unet.ZF_UNET(filters=4, s2d=True)
        params, stats = _jax_variables(module, (1, 64, 64, 3))
        model = unet.ZF_UNET(filters=4)
        shape = (2, 64, 64, 3)
    else:
        module = jax_ternaus.UNet11(s2d=True)
        params, stats = _jax_variables(module, (1, 32, 32, 3))
        model = ternaus.UNet11()
        shape = (2, 32, 32, 3)
    model.load_state_dict(state_dict_from_jax(kind, params, stats))
    model.s2d = True
    return module, {"params": params, "batch_stats": stats}, model, shape


@pytest.mark.parametrize("kind", ["zf_unet", "unet11"])
def test_s2d_forward_matches_segtpu_s2d(kind, monkeypatch):
    """The port's s2d form against segtpu's s2d form on segtpu's seeded
    weights: eval logits, and for zf_unet train-mode logits (batch
    statistics), atol 3e-4 in fp32, dropout off on both sides."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    module, variables, model, shape = _segtpu_s2d_case(kind)
    x = _rand(shape, 70)
    _no_dropout(model)
    want = jax.jit(lambda v, a: module.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=3e-4)
    if kind == "zf_unet":
        want, _ = jax.jit(lambda v, a: module.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = model.train()(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=3e-4)


def _registry(name, **attrs):
    return (lambda: dataclasses.replace(jax_get_model(name), s2d=True, **attrs),
            lambda: get_model(name, device="cpu"), jax_params._ENTRY_BUILDERS[name])


NARROW_TIRAMISU_ENTRIES = lambda: jax_params._entries_tiramisu((2, 2), (2, 2), 2)  # noqa: E731
# name: (segtpu module in s2d form, the port's model, its mapping, input side,
# the port's attributes besides s2d)
SEGTPU_S2D = {
    "zf_unet": (lambda: jax_unet.ZF_UNET(filters=4, s2d=True), lambda: unet.ZF_UNET(filters=4),
                jax_params._ENTRY_BUILDERS["zf_unet"], 64, {}),
    "zf_unet_deep": (lambda: jax_unet.ZF_UNET(filters=4, s2d=True, s2d_deep=True),
                     lambda: unet.ZF_UNET(filters=4), jax_params._ENTRY_BUILDERS["zf_unet"], 64,
                     dict(s2d_deep=True)),
    "unet": (lambda: jax_unet.UNet(n_filters=4, s2d=True), lambda: unet.UNet(n_filters=4),
             jax_params._ENTRY_BUILDERS["unet"], 48, {}),
    "unet_deep": (lambda: jax_unet.UNet(n_filters=4, s2d=True, s2d_deep=True),
                  lambda: unet.UNet(n_filters=4), jax_params._ENTRY_BUILDERS["unet"], 48,
                  dict(s2d_deep=True)),
    "unet_abn": (lambda: jax_unet.UNetABN(n_filters=4, s2d=True),
                 lambda: unet.UNetABN(n_filters=4), jax_params._ENTRY_BUILDERS["unet_abn"], 48,
                 {}),
    "unet11": _registry("unet11") + (32, {}),
    "unet16": _registry("unet16") + (32, {}),
    "linknet34": _registry("linknet34") + (64, {}),
    "linknext": _registry("linknext") + (32, {}),
    "squeezenet": _registry("squeezenet") + (32, {}),
    "fcdensenet": (lambda: jax_tiramisu.FCDenseNet(**NARROW_TIRAMISU, s2d=True),
                   lambda: tiramisu.FCDenseNet(**NARROW_TIRAMISU), NARROW_TIRAMISU_ENTRIES, 32,
                   {}),
}


@pytest.mark.parametrize("name", sorted(SEGTPU_S2D))
def test_s2d_model_matches_segtpu_s2d(name, monkeypatch):
    """Every model with an s2d mode, its s2d form against segtpu's s2d form
    on segtpu's seeded weights (``_compare``): eval logits, train-mode
    logits (batch statistics) and every running statistic after that
    forward, atol 3e-4 in fp32, dropout off on both sides."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    make_module, make_model, entries, side, attrs = SEGTPU_S2D[name]
    model = make_model()
    for k, v in dict(s2d=True, **attrs).items():
        setattr(model, k, v)
    n_stats = sum(k.endswith("running_mean") for k in model.state_dict())
    _compare(make_module(), model, entries(), _rand((2, side, side, 3), 71), n_stats)


@pytest.mark.parametrize("name", ["zf_unet", "unet_abn", "fcdensenet"])
def test_s2d_gradients_match_segtpu_s2d_in_float64(name, monkeypatch):
    """One train-mode backward of a weighted sum of the logits: every
    parameter gradient of the port's s2d form in float64 against segtpu's
    s2d form run in float64 (``jax.enable_x64``), within 1e-6 of the
    tensor's largest |g| (floored at 1e-3 of the model's largest; segtpu
    rounds its logits to fp32, so its gradients carry fp32's rounding)."""
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)
    make_module, make_model, entries, side, attrs = SEGTPU_S2D[name]
    module = make_module()
    params, stats = _jax_variables(module, (1, side, side, 3))
    model = make_model()
    model.load_state_dict(jax_params.state_dict_from_entries(entries(), params, stats))
    model = _no_dropout(model).double().train()
    model.s2d = True
    x = _rand((2, side, side, 3), 72, np.float64)
    out = model(_nchw(x))
    w = np.linspace(-1.0, 1.0, out.numel()).reshape(_nhwc(out).shape)
    (out * _nchw(w)).sum().backward()
    want = _segtpu_f64_grads(module, entries(), params, stats, x, w)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want.values())
    assert max(_grad_errors(got, want, floor)) <= 1e-6


@pytest.mark.parametrize("name", jax_model_names())
def test_registry_s2d_modes_are_segtpus(name):
    """A registry model has an ``s2d`` attribute where segtpu's has an s2d
    field; with it set the model loads its own normal-form state_dict with
    ``strict=True`` (the same modules in both forms)."""
    model = get_model(name, patch_size=64, device="cpu")
    assert hasattr(model, "s2d") == hasattr(jax_get_model(name), "s2d"), name
    assert name in model_names()
    if hasattr(model, "s2d"):
        state = model.state_dict()
        model.s2d = True
        model.load_state_dict(state, strict=True)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _cli(exp_dir, model, *extra):
    return ["-m", model, "-d", "shapes", "-l", "bce", "-o", "sgd", "-lr", "1e-3", "-b", "2",
            "-p", "64", "-s", "1", "-e", "1", "--device", "cpu", "--no-tensorboard",
            "--seed", "0", "--experiments-dir", str(exp_dir), *extra]


def test_train_cli_s2d_trains_zf_unet(tmp_path, monkeypatch):
    """``-m zf_unet --s2d`` runs a 1-step epoch through the s2d form and
    writes its CSV; ``-r -e 2`` resumes it in s2d form, and its second
    epoch's loss is an unbroken two-epoch run's, bit for bit."""
    seen = []
    real = train_cli.make_train_step

    def spy(model, *args, **kwargs):
        seen.append(model.s2d)
        return real(model, *args, **kwargs)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    history = train_cli.main(_cli(tmp_path, "zf_unet", "--s2d"))
    assert seen == [True] and history["epoch"] == [0]
    assert np.isfinite(history["loss"]).all()
    assert (tmp_path / "shapes" / "bce" / "shapes_zf_unet_64_rgb_bce").is_dir()
    resumed = train_cli.main(_cli(tmp_path, "zf_unet", "--s2d", "-e", "2", "-r"))
    unbroken = train_cli.main(_cli(tmp_path / "unbroken", "zf_unet", "--s2d", "-e", "2"))
    assert seen == [True] * 3 and resumed["epoch"][-1] == 1
    assert resumed["loss"][-1] == unbroken["loss"][-1]


def test_submit_cli_s2d_exits_for_a_model_without_s2d(tmp_path):
    """segtpu's message for a model that has no s2d mode."""
    with pytest.raises(SystemExit, match="--s2d: model 'albunet' has no s2d mode"):
        submit_cli.main(["-m", "albunet", "-c", "x.pth", "--s2d", "--device", "cpu",
                         "--submits-dir", str(tmp_path / "s")])


def test_s2d_path_runs_the_kernels_wrappers(monkeypatch):
    """On the s2d path every normalisation goes through the dispatchers
    with the 4x channel count: a zf_unet (4 filters) step calls B1 44 and B2
    22 times, each on its s2d or normal-space input."""
    calls = []
    for name in ("channel_sums", "abn_norm_act"):
        real = getattr(abn, name)

        def record(x, *args, _real=real, _name=name, **kwargs):
            calls.append((_name, tuple(x.shape)))
            return _real(x, *args, **kwargs)

        monkeypatch.setattr(abn, name, record)
    model = unet.ZF_UNET(filters=4).train()
    model.s2d = True
    model(torch.from_numpy(_rand((2, 3, 64, 64), 80))).sum().backward()
    assert sum(n == "channel_sums" for n, _ in calls) == 44
    assert sum(n == "abn_norm_act" for n, _ in calls) == 22
    # conv_224 and up_conv_224: 2 BatchNorms each on 4 x 4 s2d channels
    assert sum(s == (2, 16, 32, 32) for n, s in calls if n == "abn_norm_act") == 4
    assert kernels.launch_counts() == {"channel_sums": 0, "abn_norm_act": 0, "abn_bwd": 0}
