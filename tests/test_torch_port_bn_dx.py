"""BNTrain's dx pass: ``segtpu_torch.ops.abn.bn_dx`` and the launch plan of
its CUDA kernel (``segtpu_torch.ops.kernels.bn_dx_plan``).

The kernel of ``csrc/bn_dx.cu`` runs only on the card. Here, on the CPU:

* ``BNTrain``'s input gradient equals, bit for bit, the expression that the
  pass replaced, in bf16, fp32 and float64, NCHW, channels_last and
  [M, C], with and without s2d ``parts``;
* the dispatcher takes the plain version on the CPU and the kernel's wrapper
  refuses CPU tensors;
* the plan, B2's rules with two inputs, at every BatchNorm input shape of a
  training step of the models whose steps ``chip_smoke.py`` times
  (tiramisu67's widths, tiramisu57's C = 4 mod 8) and at odd shapes, in
  fp32 and bf16, aligned and unaligned, for cards of 132 and 114 SMs:
  covers every element once with the channels its thread holds in
  registers, stays within the launcher's checks, is the same for the same
  inputs and refuses what the kernel cannot take;
* an emulation of the kernel's walk and arithmetic (each fp32 operation
  rounded, in the expression's order, then one rounding to the output type)
  equals ``bn_dx_plain`` bit for bit on small tensors.

The loop emulation is B2's (``test_torch_port_norm_act_plan``): both kernels
walk one plan layout.
"""

import math

import numpy as np
import pytest
import torch

import test_torch_port_norm_act_plan as b2plan
from segtpu_torch.ops import abn, kernels

EPS = 1e-5
LAYOUTS = ["nchw", "channels_last", "mc"]
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(BITS[t.dtype])


def _input(shape, dtype, layout, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 2.0 + 0.3).to(dtype)
    if layout == "mc":
        return x.permute(0, 2, 3, 1).reshape(-1, shape[1])
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    return x


def _replaced_dx(g, x, weight, mean, rstd, parts):
    """``BNTrain.backward``'s ``dx`` as the expression that the dx pass
    replaced, for no process group."""
    count = x.numel() // x.shape[1]
    g = abn._like(g, x)
    sub_bias, sub_sgx = abn.channel_sums(g, x)
    d_bias, sgx = abn._sum_to_dense(sub_bias, parts), abn._sum_to_dense(sub_sgx, parts)
    d_weight = (sgx - mean * d_bias) * rstd
    w = weight.to(rstd.dtype) * rstd
    if parts is not None:
        count = count * 4
    a = abn._expand_parts(w * d_bias / count, parts)
    b2 = abn._expand_parts(w * rstd * d_weight / count, parts)
    view, acc = abn._channel_view(x), rstd.dtype
    dx = (g.to(acc) * abn._expand_parts(w, parts).view(view)
          - (x.to(acc) - abn._expand_parts(mean, parts).view(view)) * b2.view(view)
          - a.view(view))
    return dx.to(x.dtype)


@pytest.mark.parametrize("parts", [None, (2, 3)], ids=["dense", "parts"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "fp32", "fp64"])
def test_bn_train_dx_equals_the_replaced_expression(dtype, layout, parts):
    """The input gradient of ``bn_train`` through autograd against the
    replaced expression on the forward's own ``mean`` and ``rstd``."""
    features = 5 if parts is None else sum(parts)
    channels = features if parts is None else 4 * features
    shape = (3, channels, 7, 6)
    x = _input(shape, dtype, layout, 0).requires_grad_(True)
    g = _input(shape, dtype, layout, 1)
    gen = torch.Generator().manual_seed(2)
    wdtype = torch.float64 if dtype == torch.float64 else torch.float32
    weight = (torch.rand(features, generator=gen, dtype=torch.float64) + 0.5).to(wdtype)
    bias = torch.randn(features, generator=gen, dtype=torch.float64).to(wdtype)
    y, mean, var = abn.bn_train(x, weight, bias, EPS, parts=parts)
    y.backward(g)
    want = _replaced_dx(g, x.detach(), weight, mean, torch.rsqrt(var + EPS), parts)
    assert x.grad.dtype == dtype and x.grad.shape == x.shape
    assert torch.equal(_bits(x.grad), _bits(want))


def test_bn_dx_dispatch_takes_plain_path_on_cpu():
    """A CPU tensor goes to the plain version; no kernel's launch count
    moves."""
    kernels.reset_launch_counts()
    g, x = _input((2, 6, 4, 5), torch.float32, "channels_last", 3), _input(
        (2, 6, 4, 5), torch.float32, "channels_last", 4)
    vecs = [torch.randn(6, generator=torch.Generator().manual_seed(k)) for k in range(4)]
    got = abn.bn_dx(g, x, *vecs)
    want = abn.bn_dx_plain(g, x, *vecs)
    assert torch.equal(_bits(got), _bits(want))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert kernels.launch_counts() == {"channel_sums": 0, "abn_norm_act": 0, "abn_bwd": 0,
                                       "bn_dx": 0}


def test_bn_dx_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: a CPU tensor is an error there."""
    x = torch.zeros(2, 4, 3, 3)
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bn_dx_cuda(x, x, v, v, v, v)
    assert kernels.WRAPPERS["bn_dx"] is kernels.bn_dx_cuda
    assert kernels.SOURCES["bn_dx"] == "bn_dx.cu"


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------

# The distinct BatchNorm input shapes of one training step (B2's table, which
# holds InPlaceABN's too) of the models chip_smoke.py times, and B2's odd
# cases (C = 37, C = 4 mod 8, ragged M and tails, NCHW, [M, C]).
BN_MODELS = ("tiramisu67", "tiramisu57", "linknet34", "zf_unet", "albunet")
CASES = (sorted({(s, "channels_last") for m in BN_MODELS for s in b2plan.STEP_SHAPES[m]})
         + b2plan.ODD_CASES)
DTYPES = [torch.float32, torch.bfloat16]
SMS = [132, 114]
case_id = b2plan._case_id


def _plan(case, dtype, aligned, sms):
    shape, layout = case
    return kernels.bn_dx_plan(shape, dtype, b2plan._inner(shape, layout), aligned, sms)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bn_dx_plan_covers_every_element_once(case, dtype, aligned, sms):
    shape, layout = case
    p = _plan(case, dtype, aligned, sms)
    c, numel = shape[1], math.prod(shape)
    assert p.rows_layout == (b2plan._inner(shape, layout) == 1)
    if not p.rows_layout:  # the planes loop: covered in full on small tensors below
        assert p.tx == kernels.NORM_ACT_THREADS and p.blocks >= 1
        return
    n_vec = numel // p.vec
    assert p.cols * p.vec == math.lcm(c, p.vec)
    regs = b2plan._register_channels(p)
    chunk = p.unroll * p.ty
    last_trip = b2plan._trips(p) - 1
    trips = sorted({0, 1, max(0, last_trip - 1), last_trip})
    for tile in sorted({0, p.col_tiles - 1}):
        for block in sorted({0, p.blocks - 1}):
            v, col = b2plan._rows_loads(p, block, tile, trips)
            assert len(np.unique(v)) == len(v)
            assert np.all(v % p.cols == col)
            assert np.all((v // p.cols // chunk) % p.blocks == block)
            for t in trips:
                lo = (t * p.blocks + block) * chunk
                period = v // p.cols
                got = v[(period >= lo) & (period < lo + chunk)]
                want = (np.arange(lo, lo + chunk)[:, None] * p.cols
                        + np.arange(tile * p.tx, min(p.cols, (tile + 1) * p.tx)))
                np.testing.assert_array_equal(np.sort(got), want[want < n_vec])
            elems = v[:, None] * p.vec + np.arange(p.vec)
            np.testing.assert_array_equal(regs[col], elems % c)
    last_chunk = (n_vec - 1) // p.cols // chunk
    v, _ = b2plan._rows_loads(p, last_chunk % p.blocks, (n_vec - 1) % p.cols // p.tx,
                              [last_chunk // p.blocks])
    assert n_vec - 1 in v
    assert len(b2plan._rows_tail(p)) < p.vec and len(b2plan._rows_tail(p)) <= p.threads


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bn_dx_plan_within_limits(case, dtype, aligned, sms):
    """The launcher's checks (``plan_ok``), the grid no larger than its
    target, and B2's plan but for the loads in flight and the blocks."""
    shape, layout = case
    p = _plan(case, dtype, aligned, sms)
    assert p.vec == (16 // dtype.itemsize if aligned else 1)
    assert p.channels == shape[1] and p.numel == math.prod(shape)
    assert p.numel % (p.channels * p.inner) == 0
    assert 1 <= p.threads <= kernels.NORM_ACT_THREADS
    assert 1 <= p.blocks <= kernels.MAX_GRID
    b2 = kernels.norm_act_plan(shape, dtype, p.inner, aligned, sms)
    if p.rows_layout:
        assert p.inner == 1 and p.unroll == kernels.BN_DX_UNROLL
        assert p.cols == math.lcm(p.channels, p.vec) // p.vec
        assert p.col_tiles == -(-p.cols // p.tx) <= kernels.MAX_GRID_Y
        # four coefficients of vec channels a thread, whatever C is
        assert p.cols <= p.channels
        assert p.blocks <= -(-kernels.BN_DX_BLOCKS_PER_SM * sms // p.col_tiles)
        assert (p.blocks - 1) * p.unroll * p.ty < p.periods
        assert (p.vec, p.cols, p.tx, p.ty, p.col_tiles) == (b2.vec, b2.cols, b2.tx, b2.ty,
                                                            b2.col_tiles)
    else:
        assert p == b2
    assert list(p.packed) == [int(getattr(p, f)) for f in (
        "rows_layout", "vec", "channels", "inner", "numel", "cols", "tx", "ty", "col_tiles",
        "unroll", "blocks")]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bn_dx_plan_is_the_same_for_the_same_inputs(case, dtype, aligned, sms):
    first = _plan(case, dtype, aligned, sms)
    kernels.bn_dx_plan.cache_clear()
    again = _plan(case, dtype, aligned, sms)
    assert first == again and list(first.packed) == list(again.packed)
    shape, layout = case
    assert kernels.bn_dx_plan(torch.Size(shape), dtype, b2plan._inner(shape, layout), aligned,
                              sms) is again


def test_bn_dx_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError, match="bn_dx"):
        kernels.bn_dx_plan((4, 8), torch.float16, 1, True, 132)
    with pytest.raises(TypeError):
        kernels.bn_dx_plan((4, 8), torch.float64, 1, True, 132)
    with pytest.raises(ValueError, match="bn_dx"):  # inner does not divide the elements
        kernels.bn_dx_plan((4, 8, 3), torch.float32, 5, True, 132)
    with pytest.raises(ValueError):
        kernels.bn_dx_plan((4, 0), torch.float32, 1, True, 132)
    with pytest.raises(ValueError):
        kernels.bn_dx_plan((4,), torch.float32, 1, True, 132)
    with pytest.raises(ValueError):
        kernels.bn_dx_plan((4, 8), torch.float32, 1, True, 0)
    with pytest.raises(ValueError, match="channels"):
        kernels.bn_dx_plan((1, 2**24 + 1), torch.bfloat16, 1, True, 132)


@pytest.mark.parametrize("sms", [132, 114, 2], ids=["sms132", "sms114", "sms2"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", b2plan.EMU_CASES, ids=case_id)
def test_bn_dx_emulation_matches_plain(case, dtype, aligned, sms):
    """Every element written once, with its own channel's four
    coefficients; the result equal to the plain version's bits. Two SMs
    give every block several loop trips."""
    shape, layout = case
    p = _plan(case, dtype, aligned, sms)
    idx, chan = b2plan._rows_elements(p) if p.rows_layout else b2plan._planes_elements(p)
    np.testing.assert_array_equal(np.sort(idx), np.arange(p.numel))
    channel_of = np.arange(p.numel) % shape[1] if p.rows_layout else (
        np.arange(p.numel) // p.inner) % shape[1]
    np.testing.assert_array_equal(chan, channel_of[idx])
    rng = np.random.default_rng(0)

    def tensor(mean, std):
        x = torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32)).to(dtype)
        return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x

    g, x = tensor(0.0, 1.0), tensor(0.3, 2.0)
    w, mean, b2, a = (torch.from_numpy(rng.normal(0.0, 1.0, shape[1]).astype(np.float32))
                      for _ in range(4))
    fg = b2plan._memory_order(g, layout).float().numpy()[idx]
    fx = b2plan._memory_order(x, layout).float().numpy()[idx]
    k = [v.numpy()[chan] for v in (w, mean, b2, a)]
    y = np.empty(p.numel, np.float32)
    # each fp32 operation rounded, in the expression's order (no FMA)
    y[idx] = (fg * k[0] - (fx - k[1]) * k[2]) - k[3]
    got = torch.from_numpy(y).to(dtype)
    want = b2plan._memory_order(abn.bn_dx_plain(g, x, w, mean, b2, a), layout)
    assert torch.equal(_bits(got), _bits(want))
