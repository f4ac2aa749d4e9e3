"""The launch plan of the B2 kernel (``segtpu_torch.ops.kernels.norm_act_plan``).

The CUDA kernel of ``csrc/abn_norm_act.cu`` runs only on the card; its launch
plan is computed in Python and is checked here on the CPU, at every B2 input
shape of one training step of each model that ``chip_smoke.py`` trains
(recorded by ``profile_reduce.step_norm_shapes``' hooks and written out as
literals), at the twelve decoder shapes of a serving pass, and at odd shapes
(C = 37, C = 4 mod 8, a ragged M), in fp32 and bf16, aligned and unaligned,
for cards of 132 and 114 SMs:

* the kernel's loops, emulated in numpy, load every vector once with the
  channels that its thread holds in registers: at the full shapes the first
  two and the last two trips of the first and the last block of the first
  and the last column tile, on small tensors every load of every block;
* the plan stays within the launcher's checks (``plan_ok``);
* it is the same for the same inputs, and it refuses what the kernel cannot
  take;
* an emulation of the kernel's arithmetic in the plan's order (fp32 multiply
  then add, each rounded, then the activation, one rounding to the output
  type) equals ``abn_norm_act_plain`` bit for bit on small tensors.
"""

import math

import numpy as np
import pytest
import torch

from segtpu_torch.ops import abn, kernels

SLOPE = 0.01


def _shapes(batch, by_side):
    return [(batch, c, s, s) for s, channels in by_side.items() for c in channels]


# The distinct B2 input shapes of one training step (BatchNorm and InPlaceABN
# layers), by model, at chip_smoke.py's batch and patch 512.
STEP_SHAPES = {
    "linknet34": _shapes(16, {256: (16, 64), 128: (16, 32, 64), 64: (32, 64, 128),
                              32: (64, 128, 256), 16: (128, 512)}),
    "zf_unet": _shapes(16, {512: (32,), 256: (64,), 128: (128,), 64: (256,), 32: (512,),
                            16: (1024,)}),
    "unet_abn": _shapes(16, {512: (32,), 256: (32, 64), 128: (64, 128), 64: (128, 256),
                             32: (256,)}),
    "tiramisu67": _shapes(4, {
        512: (48, 64, 80, 96, 112, 128, 208, 224, 240, 256, 272),
        256: (128, 144, 160, 176, 192, 208, 288, 304, 320, 336, 352),
        128: (208, 224, 240, 256, 272, 288, 368, 384, 400, 416, 432),
        64: (288, 304, 320, 336, 352, 368, 448, 464, 480, 496, 512),
        32: (368, 384, 400, 416, 432, 448, 528, 544, 560, 576, 592),
        16: (448, 464, 480, 496, 512)}),
    "tiramisu57": _shapes(4, {
        512: (48, 60, 72, 84, 96, 144, 156, 168, 180),
        256: (96, 108, 120, 132, 144, 192, 204, 216, 228),
        128: (144, 156, 168, 180, 192, 240, 252, 264, 276),
        64: (192, 204, 216, 228, 240, 288, 300, 312, 324),
        32: (240, 252, 264, 276, 288, 336, 348, 360, 372),
        16: (288, 300, 312, 324)}),
    "albunet": _shapes(16, {256: (64,), 128: (64,), 64: (128,), 32: (256,), 16: (512,)}),
}
assert [len(v) for v in STEP_SHAPES.values()] == [13, 6, 8, 60, 49, 5]
# The twelve InPlaceABN inputs of one LinkNet34 serving pass (tile batch 64).
SERVE_SHAPES = [(64, c, s, s) for c, s in ((128, 16), (128, 32), (256, 32), (64, 32),
                                           (64, 64), (128, 64), (32, 64), (32, 128),
                                           (64, 128), (16, 128), (16, 256), (64, 256))]
# (shape, layout): C = 37, C = 4 mod 8 (tiramisu57 grows by 12), a ragged M
# with a ragged element tail, C = 1024, a row-major [M, C] view.
ODD_CASES = [((3, 37, 19, 23), "channels_last"), ((3, 37, 19, 23), "nchw"),
             ((4, 180, 512, 512), "channels_last"), ((5, 12, 7, 9), "channels_last"),
             ((1499, 37), "mc"), ((1501, 12), "mc"), ((16, 1024, 16, 16), "channels_last"),
             ((2, 24, 17, 9), "nchw")]
CASES = (sorted({(s, "channels_last") for shapes in STEP_SHAPES.values() for s in shapes}
                | {(s, "channels_last") for s in SERVE_SHAPES}) + ODD_CASES)
DTYPES = [torch.float32, torch.bfloat16]
SMS = [132, 114]


def _inner(shape, layout):
    return int(np.prod(shape[2:])) if layout == "nchw" else 1


def _case_id(case):
    shape, layout = case
    return "x".join(map(str, shape)) + f"-{layout}"


def _plan(case, dtype, aligned, sms):
    shape, layout = case
    return kernels.norm_act_plan(shape, dtype, _inner(shape, layout), aligned, sms)


def _register_channels(plan):
    """[cols, vec]: the channels each column's thread loads into registers,
    by the kernel's own loop (start at (col * vec) mod C, step and wrap)."""
    regs = np.empty((plan.cols, plan.vec), np.int64)
    for col in range(plan.cols):
        c = (col * plan.vec) % plan.channels
        for e in range(plan.vec):
            regs[col, e] = c
            c = 0 if c + 1 == plan.channels else c + 1
    return regs


def _trips(plan):
    """Loop trips of the rows kernel's busiest thread."""
    n_vec = plan.numel // plan.vec
    return math.ceil(n_vec / (plan.blocks * plan.unroll * plan.ty * plan.cols))


def _rows_loads(plan, block, tile, trips):
    """(vector index, column) of every load that block ``block`` of column
    tile ``tile`` makes in loop trips ``trips``, as the rows kernel walks
    them: thread (x, y) owns column tile * tx + x, starts at period
    block * unroll * ty + y, loads ``unroll`` vectors ``ty * cols`` apart per
    trip, and moves on by ``blocks * unroll * ty * cols``; a load past the
    last vector is masked."""
    n_vec = plan.numel // plan.vec
    cols = tile * plan.tx + np.arange(plan.tx)
    cols = cols[cols < plan.cols]
    gap = plan.ty * plan.cols
    stride = plan.blocks * plan.unroll * gap
    first = (block * plan.unroll * plan.ty + np.arange(plan.ty))[:, None] * plan.cols + cols
    v = (np.asarray(trips)[:, None, None, None] * stride
         + np.arange(plan.unroll)[None, :, None, None] * gap + first[None, None])
    col = np.broadcast_to(cols, v.shape)
    keep = v < n_vec
    return v[keep], col[keep]


def _rows_tail(plan):
    n_vec = plan.numel // plan.vec
    return np.arange(n_vec * plan.vec, plan.numel)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_norm_act_plan_covers_every_element_once(case, dtype, aligned, sms):
    shape, layout = case
    p = _plan(case, dtype, aligned, sms)
    c, numel = shape[1], math.prod(shape)
    assert p.rows_layout == (_inner(shape, layout) == 1)
    if not p.rows_layout:  # the planes loop: covered in full on small tensors below
        assert p.tx == kernels.NORM_ACT_THREADS and p.blocks >= 1
        return
    n_vec = numel // p.vec
    assert p.cols * p.vec == math.lcm(c, p.vec)
    regs = _register_channels(p)
    chunk = p.unroll * p.ty  # periods a block takes per trip
    last_trip = _trips(p) - 1
    trips = sorted({0, 1, max(0, last_trip - 1), last_trip})
    for tile in sorted({0, p.col_tiles - 1}):
        for block in sorted({0, p.blocks - 1}):
            v, col = _rows_loads(p, block, tile, trips)
            assert len(np.unique(v)) == len(v)
            assert np.all(v % p.cols == col)
            period = v // p.cols
            assert np.all((period // chunk) % p.blocks == block)
            # each trip of the block loads its chunk's periods whole, but for
            # the last, partial period
            for t in trips:
                lo = (t * p.blocks + block) * chunk
                got = v[(period >= lo) & (period < lo + chunk)]
                want = (np.arange(lo, lo + chunk)[:, None] * p.cols
                        + np.arange(tile * p.tx, min(p.cols, (tile + 1) * p.tx)))
                np.testing.assert_array_equal(np.sort(got), want[want < n_vec])
            # the channel each element gets is its own: (element index) mod C
            elems = v[:, None] * p.vec + np.arange(p.vec)
            np.testing.assert_array_equal(regs[col], elems % c)
    # the last vector is loaded: by the block whose chunk holds its period
    last_chunk = (n_vec - 1) // p.cols // chunk
    v, _ = _rows_loads(p, last_chunk % p.blocks, (n_vec - 1) % p.cols // p.tx,
                       [last_chunk // p.blocks])
    assert n_vec - 1 in v
    # the element tail fits the first block's threads
    assert len(_rows_tail(p)) < p.vec and len(_rows_tail(p)) <= p.threads


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_norm_act_plan_within_limits(case, dtype, aligned, sms):
    """The launcher's checks (``plan_ok``), and a grid no larger than the
    plan's target."""
    shape, _ = case
    p = _plan(case, dtype, aligned, sms)
    full_vec = 16 // dtype.itemsize
    assert p.vec == (full_vec if aligned else 1)
    assert p.channels == shape[1] and p.numel == math.prod(shape)
    assert p.numel % (p.channels * p.inner) == 0
    assert 1 <= p.threads <= kernels.NORM_ACT_THREADS
    assert 1 <= p.blocks <= kernels.MAX_GRID
    if p.rows_layout:
        assert p.inner == 1 and p.unroll == kernels.NORM_ACT_UNROLL
        assert p.cols == math.lcm(p.channels, p.vec) // p.vec
        assert p.col_tiles == -(-p.cols // p.tx) <= kernels.MAX_GRID_Y
        assert p.tx == -(-p.cols // p.col_tiles)  # the fewest, even tiles
        assert p.ty == max(1, kernels.NORM_ACT_THREADS // p.tx)
        # per-channel operands: 2 * vec floats a thread, whatever C is
        assert p.cols <= p.channels
        assert p.blocks <= -(-kernels.NORM_ACT_BLOCKS_PER_SM * sms // p.col_tiles)
        # no block without a period to load on its first trip
        assert (p.blocks - 1) * p.unroll * p.ty < p.periods
    else:
        assert (p.cols, p.ty, p.col_tiles, p.unroll) == (0, 1, 1, 1)
        assert p.blocks <= kernels.PLANES_BLOCKS_PER_SM * sms
    assert len(p.packed) == 11
    assert list(p.packed) == [int(getattr(p, f)) for f in (
        "rows_layout", "vec", "channels", "inner", "numel", "cols", "tx", "ty", "col_tiles",
        "unroll", "blocks")]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_norm_act_plan_is_the_same_for_the_same_inputs(case, dtype, aligned, sms):
    first = _plan(case, dtype, aligned, sms)
    kernels.norm_act_plan.cache_clear()
    again = _plan(case, dtype, aligned, sms)
    assert first == again and list(first.packed) == list(again.packed)
    shape, layout = case
    assert kernels.norm_act_plan(torch.Size(shape), dtype, _inner(shape, layout), aligned,
                                 sms) is again


def test_norm_act_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError):
        kernels.norm_act_plan((4, 8), torch.float16, 1, True, 132)
    with pytest.raises(ValueError):  # inner does not divide the elements
        kernels.norm_act_plan((4, 8, 3), torch.float32, 5, True, 132)
    with pytest.raises(ValueError):
        kernels.norm_act_plan((4, 0), torch.float32, 1, True, 132)
    with pytest.raises(ValueError):
        kernels.norm_act_plan((4,), torch.float32, 1, True, 132)
    with pytest.raises(ValueError):
        kernels.norm_act_plan((4, 8), torch.float32, 1, True, 0)
    with pytest.raises(ValueError, match="channels"):  # more column tiles than grid y holds
        kernels.norm_act_plan((1, 2**24 + 1), torch.bfloat16, 1, True, 132)


# ---------------------------------------------------------------------------
# Every load of every block, and the kernel's arithmetic, on small tensors
# ---------------------------------------------------------------------------

def _planes_elements(plan):
    """(element index, channel) of every element the planes kernel writes:
    thread ``first`` of the grid loads vectors first, first + stride, ...;
    one scale and shift per vector when inner % vec == 0, else the channel
    stepped element by element; then the n % vec elements after the last
    vector, element n_vec * vec + first for each thread that has one."""
    n_vec = plan.numel // plan.vec
    threads = plan.blocks * plan.tx
    first = np.arange(threads)
    v = (np.arange(-(-n_vec // threads))[:, None] * threads + first).ravel()
    v = v[v < n_vec]
    q = v * plan.vec // plan.inner
    r, c = v * plan.vec - q * plan.inner, q % plan.channels
    idx, chan = [], []
    for e in range(plan.vec):
        idx.append(v * plan.vec + e)
        chan.append(c.copy() if plan.inner % plan.vec else q % plan.channels)
        r = r + 1
        wrap = r == plan.inner
        r, c = np.where(wrap, 0, r), np.where(wrap, (c + 1) % plan.channels, c)
    tail = n_vec * plan.vec + first
    tail = tail[tail < plan.numel]
    return (np.concatenate(idx + [tail]),
            np.concatenate(chan + [(tail // plan.inner) % plan.channels]))


def _rows_elements(plan):
    """(element index, channel) of every element the rows kernel writes:
    every load of every block and tile, then the element tail."""
    regs = _register_channels(plan)
    idx, chan = [], []
    for tile in range(plan.col_tiles):
        for block in range(plan.blocks):
            v, col = _rows_loads(plan, block, tile, range(_trips(plan)))
            idx.append((v[:, None] * plan.vec + np.arange(plan.vec)).ravel())
            chan.append(regs[col].ravel())
    tail = _rows_tail(plan)
    return (np.concatenate(idx + [tail]),
            np.concatenate(chan + [tail % plan.channels]))


def _memory_order(x, layout):
    """x's elements in memory order, as a flat tensor."""
    return x.permute(0, 2, 3, 1).reshape(-1) if layout == "channels_last" else x.reshape(-1)


# Small shapes that reach every path: rows with one and several column
# tiles' worth of channels, C = 4 mod 8, ragged M and element tails, planes
# with and without one channel per vector.
EMU_CASES = [((3, 37, 19, 23), "channels_last"), ((3, 37, 19, 23), "nchw"),
             ((5, 12, 7, 9), "channels_last"), ((3, 268, 5, 7), "channels_last"),
             ((1499, 37), "mc"), ((1501, 12), "mc"), ((2, 1024, 3, 5), "channels_last"),
             ((3, 600, 2, 3), "channels_last"), ((2, 24, 17, 9), "nchw"),
             ((2, 3, 8, 8), "nchw")]


@pytest.mark.parametrize("sms", [132, 114, 2], ids=["sms132", "sms114", "sms2"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES, ids=_case_id)
def test_norm_act_emulation_matches_plain(case, dtype, aligned, sms):
    """Every element written once, with its own channel's scale and shift;
    the result, for each activation, equal to the plain version's bits. Two
    SMs give every block several loop trips."""
    shape, layout = case
    p = _plan(case, dtype, aligned, sms)
    idx, chan = _rows_elements(p) if p.rows_layout else _planes_elements(p)
    np.testing.assert_array_equal(np.sort(idx), np.arange(p.numel))
    channel_of = np.arange(p.numel) % shape[1] if p.rows_layout else (
        np.arange(p.numel) // p.inner) % shape[1]
    np.testing.assert_array_equal(chan, channel_of[idx])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0.3, 2.0, shape).astype(np.float32)).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0.0, 1.0, shape[1]).astype(np.float32))
    flat = _memory_order(x, layout).float().numpy()
    s, b = scale.numpy()[chan], shift.numpy()[chan]
    y = np.empty(p.numel, np.float32)
    y[idx] = (flat[idx] * s) + b  # two fp32 roundings, as __fmul_rn then __fadd_rn
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for activation in ("leaky_relu", "elu", "none"):
        got = abn.act_forward(torch.from_numpy(y), activation, SLOPE).to(dtype)
        want = _memory_order(abn.abn_norm_act_plain(x, scale, shift, activation, SLOPE), layout)
        assert torch.equal(got.view(bits), want.contiguous().view(bits)), activation
