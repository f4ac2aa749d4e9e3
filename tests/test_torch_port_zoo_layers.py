"""The layers and modules that segtpu_torch's model zoo adds, against
segtpu's: ``upsample_bilinear`` (both branches), ``pixel_shuffle``, the
tuple-kernel ``Conv`` of GCN, the pyramid's adaptive average pooling, the
ResNet encoder (BasicBlock plain and dilated, Bottleneck plain, dilated and
HDC) at short depth, the ``PyramidPoolingModule`` and the
``DenseUpsamplingConvModule`` alone, and the GCN over a short encoder.

Weights are segtpu's, drawn from a seed (``torch_port_util._jax_variables``)
and carried across by ``state_dict_from_entries``; inputs are made from a
seed with numpy (NHWC for segtpu, NCHW for the port). fp32 on the CPU, the
kernels through their plain versions, torch on two threads. Forwards are
compared in eval mode (running statistics) and in training mode (batch
statistics), with the running statistics after the training forward.
segtpu's channel dropout is off (its ``DROPOUT_DISABLED``), the port's too.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.models import layers as jax_layers
from segtpu.models import duc_hdc as jax_duc
from segtpu.models import gcn as jax_gcn
from segtpu.models import psp as jax_psp
from segtpu.models.encoders import resnet as jax_resnet

from segtpu_torch.compat.jax_params import (_entries_duc_head, _entries_gcn, _entries_ppm,
                                            _entries_resnet_encoder, state_dict_from_entries)
from segtpu_torch.models import duc_hdc, gcn, layers, psp
from segtpu_torch.models.encoders import resnet

from torch_port_util import _compare, _nchw, _nhwc, _numpy_dicts

@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_segtpu_dropout(monkeypatch):
    monkeypatch.setattr("segtpu.models.layers.DROPOUT_DISABLED", True)


def _seeded(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(0.0, 1.0, shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Functional layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw, out_hw", [((4, 4), (16, 16)), ((5, 7), (17, 9)),
                                           ((8, 8), (8, 8)), ((9, 6), (4, 3)),
                                           ((1, 1), (8, 8)), ((2, 3), (64, 64)),
                                           ((6, 5), (1, 1)), ((6, 5), (1, 7)),
                                           ((6, 5), (9, 1)), ((3, 4), (6, 1)),
                                           ((1, 1), (1, 1))])
def test_upsample_bilinear_matches_segtpu(in_hw, out_hw):
    """align_corners where both output sides are above 1, else segtpu's
    ``jax.image.resize(method="linear")`` (half-pixel, antialiased when it
    shrinks), atol 1e-5: the two sides weigh the same taps in other orders,
    a few fp32 ulps of values of order one."""
    x = _seeded((2,) + in_hw + (3,), sum(in_hw) + sum(out_hw))
    want = np.asarray(jax_layers.upsample_bilinear(jnp.asarray(x), out_hw))
    got = layers.upsample_bilinear(_nchw(x), out_hw)
    assert got.shape == (2, 3) + out_hw
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


def test_upsample_bilinear_half_pixel_when_asked():
    x = _seeded((1, 5, 6, 2), 3)
    want = np.asarray(jax_layers.upsample_bilinear(jnp.asarray(x), (10, 12), align_corners=False))
    got = layers.upsample_bilinear(_nchw(x), (10, 12), align_corners=False)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("r, c", [(2, 3), (8, 1), (4, 5)])
def test_pixel_shuffle_matches_segtpu(r, c):
    """segtpu's NHWC (C, r, r) channel order is torch's NCHW order: exact."""
    x = _seeded((2, 3, 5, c * r * r), r + c)
    want = np.asarray(jax_layers.pixel_shuffle(jnp.asarray(x), r))
    got = layers.pixel_shuffle(_nchw(x), r)
    assert got.shape == (2, c, 3 * r, 5 * r)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("kernel, padding, groups", [((7, 1), (3, 0), 1), ((1, 7), (0, 3), 1),
                                                     (3, 1, 2), ((3, 5), (1, 2), 1)])
def test_conv_tuple_kernel_matches_segtpu(kernel, padding, groups):
    """A tuple kernel with per-axis padding (segtpu's ``[(p, p), (q, q)]``)
    and a grouped conv give segtpu's output on segtpu's weights (atol
    1e-5); the port's init draws U(+-1/sqrt(fan_in)) with torch's fan-in,
    in_channels / groups * kh * kw, which is segtpu's."""
    cin, cout = 4, 6
    kh, kw = kernel if isinstance(kernel, tuple) else (kernel, kernel)
    ph, pw = padding if isinstance(padding, tuple) else (padding, padding)
    module = jax_layers.Conv(cout, kernel, padding=[(ph, ph), (pw, pw)], groups=groups)
    x = _seeded((2, 9, 11, cin), kh * 10 + kw)
    params = _numpy_dicts(jax.jit(module.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    conv = layers.Conv(cin, cout, kernel, padding=padding, groups=groups)
    sd = state_dict_from_entries([("conv", "c", ("Conv_0",))], params, {})
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = conv(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)

    fan_in = cin // groups * kh * kw
    conv.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1.0 / math.sqrt(fan_in)
    for t in (conv.weight.detach(), conv.bias.detach()):
        assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.9 * bound
    assert float(np.abs(params["Conv_0"]["kernel"]).max()) <= bound


@pytest.mark.parametrize("side, bins", [(8, 1), (8, 2), (8, 3), (8, 6), (7, 3), (5, 6), (6, 6)])
def test_adaptive_avg_pool_matches_segtpu(side, bins):
    """torch's floor/ceil bins are segtpu's ``_adaptive_avg_pool``'s, also
    where the side does not divide (8 -> 3, 8 -> 6, 5 -> 6), atol 1e-6."""
    x = _seeded((2, side, side + 1, 4), side * 7 + bins)
    want = np.asarray(jax_psp._adaptive_avg_pool(jnp.asarray(x), bins))
    got = torch.nn.functional.adaptive_avg_pool2d(_nchw(x), bins)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Modules: eval and train-mode forwards, running statistics
# ---------------------------------------------------------------------------

_ENCODER_CASES = {
    "basic": dict(layers=(1, 1, 2, 1)),
    "basic_dilated": dict(layers=(1, 1, 2, 2), layer3_dilations=(2,), layer4_dilations=(4,)),
    "bottleneck": dict(layers=(1, 1, 2, 1), bottleneck=True),
    "bottleneck_dilated": dict(layers=(1, 1, 2, 1), bottleneck=True, layer3_dilations=(2,),
                               layer4_dilations=(4,)),
    "bottleneck_hdc": dict(layers=(1, 1, 5, 4), bottleneck=True,
                           layer3_dilations=(1, 2, 5, 9), layer4_dilations=(5, 9, 17)),
}


def _encoder_entries(kw):
    prefix_map = {"conv1": "conv1", "bn1": "bn1"}
    prefix_map.update({f"layer{i}": f"layer{i}" for i in range(1, 5)})
    return _entries_resnet_encoder(prefix_map, kw["layers"], root=(),
                                   bottleneck=kw.get("bottleneck", False))


def _n_bn(kw):
    # a downsample in the first block of layers 2-4, and of layer1 in a Bottleneck ResNet
    per, ds = (3, 4) if kw.get("bottleneck") else (2, 3)
    return 1 + per * sum(kw["layers"]) + ds


@pytest.mark.parametrize("case", list(_ENCODER_CASES))
def test_resnet_encoder_matches_segtpu(case):
    """(stem, e1, e2, e3, e4) at short depth, 2 x 64 x 64: eval and train,
    atol 3e-4, and the running statistics; the dilated ones keep stride 8
    (e3 and e4 at 8 x 8), the HDC one cycles its dilations per block. The
    HDC case's 12 blocks are held to segtpu in float64, from which
    segtpu's own fp32 train-mode outputs (values up to 12) stray further
    than atol and further than the port's."""
    kw = _ENCODER_CASES[case]
    module = jax_resnet.ResNetEncoder(**kw)
    model = resnet.ResNetEncoder(**kw)
    _compare(module, model, _encoder_entries(kw), _seeded((2, 64, 64, 3), 5), _n_bn(kw),
             f64=case == "bottleneck_hdc")


def test_resnet_encoder_strides_and_dilations_match_segtpu():
    """Every conv of the full-depth encoders has segtpu's stride, padding and
    dilation, and each downsample branch sits where segtpu's does, by
    segtpu's rule (resnet.py:138-160) walked block by block."""
    for factory, jkw in ((resnet.resnet34, dict(layers=(3, 4, 6, 3))),
                         (lambda: resnet.resnet34(dilated=True),
                          dict(layers=(3, 4, 6, 3), l3=(2,), l4=(4,))),
                         (resnet.resnet101, dict(layers=(3, 4, 23, 3), bn=True)),
                         (lambda: resnet.resnet101(dilated=True),
                          dict(layers=(3, 4, 23, 3), bn=True, l3=(2,), l4=(4,))),
                         (lambda: resnet.resnet152(dilated=True),
                          dict(layers=(3, 8, 36, 3), bn=True, l3=(2,), l4=(4,))),
                         (lambda: resnet.resnet152(hdc=True),
                          dict(layers=(3, 8, 36, 3), bn=True, l3=(1, 2, 5, 9), l4=(5, 9, 17)))):
        enc = factory()
        exp = 4 if jkw.get("bn") else 1
        inplanes, n_ds = 64, 0
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), jkw["layers"])):
            dil = {2: jkw.get("l3"), 3: jkw.get("l4")}.get(li)
            stride = 1 if li == 0 or dil is not None else 2
            for b in range(n):
                block = getattr(enc, f"layer{li + 1}")[b]
                d = 1 if dil is None else dil[b % len(dil)]
                s = stride if b == 0 else 1
                if jkw.get("bn"):
                    conv = block.conv2
                    assert (conv.stride, conv.dilation, conv.padding) == ((s, s), (d, d), (d, d))
                    assert block.conv1.stride == block.conv3.stride == (1, 1)
                else:
                    c1 = d if not (dil is not None and b == 0 and len(dil) == 1) else (
                        1 if d <= 2 else d // 2)
                    assert (block.conv1.stride, block.conv1.dilation, block.conv1.padding) == (
                        (s, s), (c1, c1), (c1, c1))
                    assert (block.conv2.dilation, block.conv2.padding) == ((d, d), (d, d))
                ds = b == 0 and (s != 1 or inplanes != planes * exp)
                assert (block.downsample is not None) == ds
                if ds:
                    assert block.downsample[0].stride == (s, s)
                    n_ds += 1
                inplanes = planes * exp
        assert n_ds == (4 if exp == 4 else 3)


@pytest.mark.parametrize("batch, side", [(2, 8), (2, 6), (1, 8)])
def test_pyramid_pooling_module_matches_segtpu(batch, side):
    """PSPNet's pyramid over a batch x side x side x 16 map (bins 1, 2, 3,
    6; side 8 gives bins of unequal sizes): the concatenation in eval and
    in training, and the four BatchNorms' running statistics at momentum
    0.95, atol 3e-4. A bin of 1 x 1 normalises over the batch's rows: at
    batch 1 a single value per channel, which torch's BatchNorm2d refuses
    and segtpu (and so the port) takes, its running var moved by the
    biased variance 0 (count / max(count - 1, 1))."""
    module = jax_psp.PyramidPoolingModule(8)
    model = psp.PyramidPoolingModule(16, 8)
    entries = [(k, tp.lstrip("."), fp) for k, tp, fp in _entries_ppm(tp="", fp=())]
    _compare(module, model, entries, _seeded((batch, side, side, 16), side + batch), 4)
    assert all(m.momentum == 0.95 for m in model.modules()
               if isinstance(m, layers.BatchNormTorch))


def test_dense_upsampling_conv_module_matches_segtpu():
    """DUC's head, down factor 4 and 2 classes over 2 x 6 x 5 x 12: eval and
    train, atol 3e-4, and its BatchNorm's running statistics."""
    module = jax_duc.DenseUpsamplingConvModule(4, 2)
    model = duc_hdc.DenseUpsamplingConvModule(4, 12, 2)
    entries = [(k, tp.lstrip("."), fp) for k, tp, fp in _entries_duc_head(tp="", fp=())]
    _compare(module, model, entries, _seeded((2, 6, 5, 12), 9), 1)


@pytest.mark.parametrize("bottleneck", [False, True], ids=["basic", "bottleneck"])
def test_gcn_over_a_short_encoder_matches_segtpu(bottleneck):
    """segtpu's GCN body over a short ResNet (layers 1, 1, 2, 1), 2 x 64 x
    64, 2 classes: eval and train logits, atol 3e-4, and the encoder's
    running statistics, with the encoder under ``layer0``/``layer1.1``."""
    layers_ = (1, 1, 2, 1)
    module = jax_gcn.GCN(encoder=jax_resnet.ResNetEncoder(layers=layers_, bottleneck=bottleneck),
                         num_classes=2)
    model = gcn.GCN(resnet.ResNetEncoder(layers_, bottleneck=bottleneck), num_classes=2)
    _compare(module, model, _entries_gcn(layers_, bottleneck), _seeded((2, 64, 64, 3), 13),
             _n_bn(dict(layers=layers_, bottleneck=bottleneck)))
