"""The launch plan of the B1/B3 reduction (``segtpu_torch.ops.kernels.reduce_plan``).

The CUDA kernels of ``csrc/channel_reduce.cuh`` run only on the card; their
launch plan is computed in Python and is checked here on the CPU, at every
BatchNorm and InPlaceABN input shape of one LinkNet34 training step (batch
16, patch 512), at the model zoo's BatchNorm shapes (PSPNet's pyramid at 8
to 288 rows among them) and at the odd shapes that ``chip_smoke.py`` holds the kernels
to, in fp32 and bf16, channels_last and NCHW, for cards of 132 and 114 SMs:

* the plan covers every channel, and every row (or every vector of a
  channel's planes) exactly once, following the kernel's own loops;
* it stays within the launcher's checks: the grid, the portable cluster
  size, the shared arrays, and the scratch and counters that it sizes;
* it is the same for the same inputs;
* a numpy emulation of the blocked sum, in the plan's order (each thread's
  running fp32 sum, the warp shuffles, the warps, the cluster ranks, the
  cluster partials by lanes), matches the plain versions
  ``channel_sums_plain`` and ``abn_bwd_sums_plain`` within
  ``RTOL_SUM * sum|term| + 1e-6`` per channel. For B3 the emulation forms
  the terms as the kernel does (times 1/slope, gamma taken out of the sum
  and divided once per channel), where the plain version divides every
  term.
"""

import numpy as np
import pytest
import torch

from segtpu_torch.ops import abn, kernels

RTOL_SUM = 1e-5  # fp32 sums added in two different orders
ATOL_SUM = 1e-6
SLOPE = 0.01
THREADS = kernels.REDUCE_THREADS
WARPS = THREADS // 32

# Input shapes of the 36 BatchNorm and 12 InPlaceABN layers of one LinkNet34
# training step at batch 16, patch 512: 13 distinct.
STEP_SHAPES = sorted({
    (16, 64, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64), (16, 256, 32, 32),
    (16, 512, 16, 16),                                      # encoder BatchNorms
    (16, 128, 16, 16), (16, 128, 32, 32), (16, 256, 32, 32),  # decoder4 ABNs
    (16, 64, 32, 32), (16, 64, 64, 64), (16, 128, 64, 64),    # decoder3
    (16, 32, 64, 64), (16, 32, 128, 128), (16, 64, 128, 128),  # decoder2
    (16, 16, 128, 128), (16, 16, 256, 256), (16, 64, 256, 256),  # decoder1
})
assert len(STEP_SHAPES) == 13
# The distinct BatchNorm inputs of the model zoo's steps that LinkNet34's
# lacks (chip_smoke.py's batches: 16, or 8 over ResNet-101/152), PSPNet's
# pyramid at 8 to 288 rows among them.
ZOO_STEP_SHAPES = sorted({
    (b, c, s, s) for b, by_side in (
        (16, {256: (16,), 128: (16, 32), 64: (32, 256, 512)}),           # dilated_linknet34
        (16, {512: (64,), 256: (128, 256), 128: (128, 256, 512),
              64: (256, 512, 1024), 32: (512, 1024, 2048)}),           # linknext
        (8, {256: (64,), 128: (64, 128, 256), 64: (64, 128, 256, 512, 1024, 2048),
             32: (256, 512, 1024), 16: (512, 2048),
             6: (512,), 3: (512,), 2: (512,), 1: (512,)}))                # gcn, psp_net, duc
    for s, channels in by_side.items() for c in channels} - set(STEP_SHAPES))
assert len(ZOO_STEP_SHAPES) == 31


def _inner(shape, layout):
    """The channel stride of ``shape`` in ``layout`` (channels_last, nchw, or
    mc for a row-major [M, C])."""
    if layout in ("channels_last", "mc"):
        return 1
    return int(np.prod(shape[2:]))


# (shape, layout, aligned): the step's shapes in both layouts, then the odd
# cases of chip_smoke.py (C = 37, [M, C] with a ragged M, unaligned views).
CASES = ([(s, lay, True) for s in STEP_SHAPES + ZOO_STEP_SHAPES
          for lay in ("channels_last", "nchw")]
         + [((3, 37, 19, 23), "channels_last", True), ((3, 37, 19, 23), "nchw", True),
            ((1500, 48), "mc", True), ((1499, 37), "mc", True),
            ((2, 24, 17, 9), "nchw", False), ((2, 24, 17, 9), "channels_last", False)])
DTYPES = [torch.float32, torch.bfloat16]
SMS = [132, 114]


def _case_id(case):
    shape, layout, aligned = case
    return "x".join(map(str, shape)) + f"-{layout}" + ("" if aligned else "-unaligned")


def _plans(case, dtype, sms):
    shape, layout, aligned = case
    inner = _inner(shape, layout)
    return [(pair, kernels.reduce_plan(shape, dtype, inner, aligned, sms, pair))
            for pair in (False, True)]


def _block_items(plan, k):
    """The rows (or vectors) that the threads of block k of a tile load, as
    the kernel's loops walk them: thread t starts at begin + t % lanes, each
    trip loads ``unroll`` items ``lanes`` apart and moves on by ``step``."""
    lanes = THREADS // plan.tx if plan.rows_layout else THREADS
    begin, end = k * plan.span, min(plan.extent, (k + 1) * plan.span)
    starts = np.arange(begin, end, plan.step)
    items = (starts[:, None, None] + np.arange(plan.unroll)[None, :, None] * lanes
             + np.arange(lanes)[None, None, :]).ravel()
    return items[items < end], begin, end


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reduce_plan_covers_every_element_once(case, dtype, sms):
    shape, layout, _ = case
    c, numel = shape[1], int(np.prod(shape))
    for pair, p in _plans(case, dtype, sms):
        # channels: tiles of `width` channels, or one channel per tile
        if p.rows_layout:
            assert layout != "nchw" or int(np.prod(shape[2:])) == 1
            assert p.width == p.tx * p.vec and c % p.vec == 0
            assert (p.tiles - 1) * p.width < c <= p.tiles * p.width
            assert p.extent == numel // c
            lanes = sorted(t * p.vec + e for t in range(p.tx) for e in range(p.vec))
            assert lanes == list(range(p.width))
        else:
            assert p.tiles == c and p.width == 1 and p.tx == 1
            assert p.extent * p.vec == numel // c and p.inner % p.vec == 0
        # blocks: contiguous ranges of the extent, in order, the empty ones last
        ranges = [(k * p.span, min(p.extent, (k + 1) * p.span))
                  for k in range(p.blocks_per_tile)]
        filled = [(b, e) for b, e in ranges if e > b]
        assert filled[0][0] == 0 and filled[-1][1] == p.extent
        assert all(filled[i][1] == filled[i + 1][0] for i in range(len(filled) - 1))
        assert len(filled) > p.blocks_per_tile - p.cluster
        assert all(e <= b for b, e in ranges[len(filled):])
        # threads: each block's loops load every item of its range once
        for k in (0, len(filled) - 1):
            items, begin, end = _block_items(p, k)
            np.testing.assert_array_equal(np.sort(items), np.arange(begin, end))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reduce_plan_within_limits(case, dtype, sms):
    """The launcher's checks (``chred::plan_ok``), and the scratch and
    counters that the plan sizes hold every index the kernel writes."""
    full_vec = 16 // dtype.itemsize
    for pair, p in _plans(case, dtype, sms):
        assert p.vec in (1, full_vec)
        assert p.unroll == (2 if pair else 4)
        assert 1 <= p.cluster <= kernels.REDUCE_MAX_CLUSTER and p.clusters >= 1
        assert p.blocks_per_tile % p.cluster == 0
        assert p.grid <= kernels.MAX_GRID
        assert p.span % p.step == 0 and p.span * p.blocks_per_tile >= p.extent
        # no more blocks than the grid target asks for, but for the last
        # cluster's padding
        target = -(-kernels.REDUCE_BLOCKS_PER_SM * sms // p.tiles)
        assert p.blocks_per_tile < max(target, 1) + p.cluster
        if p.rows_layout:
            assert p.tx in (1, 2, 4, 8, 16, 32) and p.width <= kernels.REDUCE_MAX_WIDTH
            assert p.step == (THREADS // p.tx) * p.unroll
        else:
            assert p.step == THREADS * p.unroll
            assert p.extent + p.step < 2**31  # the planes kernel's 32-bit indices
        # level 2's lanes fit the warps' shared array
        lanes = min(THREADS // p.width, kernels.REDUCE_MAX_LANES)
        assert lanes * p.width <= WARPS * kernels.REDUCE_MAX_WIDTH
        if p.clusters == 1:
            assert p.scratch_bytes == 0 and p.counters == 0
        else:
            last_tile, last_cluster = p.tiles - 1, p.clusters - 1
            last_channel = min(p.channels, (last_tile + 1) * p.width) - 1
            last_index = (p.clusters + last_cluster) * p.channels + last_channel
            assert (last_index + 1) * p.acc_bytes <= p.scratch_bytes
            assert last_tile < p.counters
        assert p.acc_bytes == (8 if dtype == torch.float32 else 4)
        assert len(p.packed) == 14 and list(p.packed)[-3:] == [p.channels, p.inner, p.acc_bytes]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reduce_plan_is_the_same_for_the_same_inputs(case, dtype, sms):
    first = _plans(case, dtype, sms)
    kernels.reduce_plan.cache_clear()
    again = _plans(case, dtype, sms)
    assert first == again
    assert [list(p.packed) for _, p in first] == [list(p.packed) for _, p in again]
    shape, layout, aligned = case
    assert kernels.reduce_plan(torch.Size(shape), dtype, _inner(shape, layout), aligned, sms,
                               False) == first[0][1]


def test_reduce_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError):
        kernels.reduce_plan((4, 8), torch.float16, 1, True, 132, False)
    with pytest.raises(ValueError):
        kernels.reduce_plan((4, 8), torch.float32, 3, True, 132, False)
    with pytest.raises(ValueError):
        kernels.reduce_plan((4, 0), torch.float32, 1, True, 132, True)
    with pytest.raises(ValueError, match="channels_last"):  # 2^31 elements in one NCHW channel
        kernels.reduce_plan((1, 1, 2**16, 2**15), torch.bfloat16, 2**31, False, 132, False)


# ---------------------------------------------------------------------------
# The blocked sum in the plan's order, against the plain versions
# ---------------------------------------------------------------------------

def _acc(plan):
    """The type the kernel carries the sums in: fp64 for fp32 inputs."""
    return np.float64 if plan.acc_bytes == 8 else np.float32


def _combine(plan, blk):
    """Cluster ranks in order, then (with several clusters) the second
    level's lanes. ``blk``: [..., blocks_per_tile, width] block sums."""
    cl = blk.reshape(blk.shape[:-2] + (plan.clusters, plan.cluster, blk.shape[-1]))
    leader = cl[..., 0, :].copy()
    for r in range(1, plan.cluster):
        leader = leader + cl[..., r, :]
    if plan.clusters == 1:
        return leader[..., 0, :]
    lanes = min(THREADS // plan.width, kernels.REDUCE_MAX_LANES)
    total = np.zeros(leader.shape[:-2] + leader.shape[-1:], _acc(plan))
    for lane in range(lanes):
        acc = np.zeros_like(total)
        for k in range(lane, plan.clusters, lanes):
            acc = acc + leader[..., k, :]
        total = total + acc
    return total


def _butterfly(x, axis_len):
    """The warp's xor shuffles, offsets in increasing order, over the last-but-one axis."""
    d = 1
    while d < axis_len:
        x = x + x[..., np.arange(axis_len) ^ d, :]
        d *= 2
    return x[..., 0, :]


def _emulate_rows(plan, terms):
    """terms: [M, C] of one sum, rows layout."""
    m, c = terms.shape
    ty_n, width = THREADS // plan.tx, plan.width
    padded = np.zeros((plan.blocks_per_tile * plan.span, plan.tiles * width), _acc(plan))
    padded[:m, :c] = terms
    # [tile, block, trip row, thread row, column]
    x = padded.reshape(plan.blocks_per_tile, plan.span // ty_n, ty_n, plan.tiles, width)
    x = x.transpose(3, 0, 1, 2, 4)
    acc = np.zeros((plan.tiles, plan.blocks_per_tile, ty_n, width), _acc(plan))
    for i in range(x.shape[2]):
        acc = acc + x[:, :, i]
    per_warp = ty_n // WARPS
    warps = _butterfly(acc.reshape(plan.tiles, plan.blocks_per_tile, WARPS, per_warp, width),
                       per_warp)
    blk = np.zeros((plan.tiles, plan.blocks_per_tile, width), _acc(plan))
    for w in range(WARPS):
        blk = blk + warps[:, :, w]
    return _combine(plan, blk).reshape(-1)[:c]


def _emulate_planes(plan, terms):
    """terms: [C, N*H*W] of one sum, each channel's elements in memory order."""
    c, n = terms.shape
    padded = np.zeros((c, plan.blocks_per_tile * plan.span * plan.vec), _acc(plan))
    padded[:, :n] = terms
    x = padded.reshape(c, plan.blocks_per_tile, plan.span // THREADS, THREADS, plan.vec)
    acc = np.zeros((c, plan.blocks_per_tile, THREADS), _acc(plan))
    for i in range(x.shape[2]):
        for e in range(plan.vec):
            acc = acc + x[:, :, i, :, e]
    warps = _butterfly(acc.reshape(c, plan.blocks_per_tile, WARPS, 32)[..., None], 32)[..., 0]
    blk = np.zeros((c, plan.blocks_per_tile), _acc(plan))
    for w in range(WARPS):
        blk = blk + warps[:, :, w]
    return _combine(plan, blk[..., None])[..., 0]


def _emulate(plan, u, v):
    """Both sums of the kernel, in its accumulation type, for per-element
    terms ``u``, ``v`` (torch tensors of the input's shape)."""
    c = u.shape[1]
    if plan.rows_layout:
        def flat(t):
            return t.movedim(1, -1).reshape(-1, c).numpy()
        return _emulate_rows(plan, flat(u)), _emulate_rows(plan, flat(v))

    def flat(t):
        return t.movedim(1, 0).reshape(c, -1).numpy()
    return _emulate_planes(plan, flat(u)), _emulate_planes(plan, flat(v))


def _assert_close(got, want, magnitude, what):
    got, want, magnitude = (np.asarray(t, np.float64) for t in (got, want, magnitude))
    err = np.abs(got - want)
    assert np.all(err <= RTOL_SUM * magnitude + ATOL_SUM), f"{what}: max err {err.max()}"


# Small shapes that reach every path: rows and planes, vectors and scalars,
# several channel tiles, one and several clusters per tile.
EMU_CASES = [((3, 37, 19, 23), "channels_last", True), ((3, 37, 19, 23), "nchw", True),
             ((1500, 48), "mc", True), ((1499, 37), "mc", True),
             ((2, 24, 17, 9), "nchw", False), ((2, 64, 32, 32), "nchw", True),
             ((1, 2, 256, 256), "nchw", True),
             ((4, 16, 64, 64), "channels_last", True), ((2, 512, 8, 8), "channels_last", True),
             ((8, 512, 1, 1), "channels_last", True), ((8, 512, 2, 2), "channels_last", True),
             ((8, 512, 3, 3), "channels_last", True), ((8, 512, 6, 6), "channels_last", True),
             ((8, 512, 1, 1), "nchw", True)]


def _input(rng, shape, dtype, mean, std):
    """A seeded fp32 tensor rounded through ``dtype``."""
    return torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32)).to(dtype).float()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES, ids=_case_id)
def test_blocked_channel_sums_match_plain(case, dtype, pair, sms):
    shape, layout, aligned = case
    plan = kernels.reduce_plan(shape, dtype, _inner(shape, layout), aligned, sms, pair)
    rng = np.random.default_rng(0)
    a = _input(rng, shape, dtype, 0.3, 2.0)
    b = _input(rng, shape, dtype, -0.2, 1.0) if pair else a
    # the kernel's products: exact in fp64 for fp32 inputs, fp32 for bf16
    prod = a.double() * b.double() if dtype == torch.float32 else a * b
    got = [t.astype(np.float32) for t in _emulate(plan, a, prod)]
    want = abn.channel_sums_plain(a, b if pair else None)
    magnitude = abn.channel_sums_plain(a.abs(), b.abs() if pair else None)
    for g, w, m, what in zip(got, want, magnitude, ("sum a", "sum a*b")):
        _assert_close(g, w.numpy(), m.numpy(), what)


@pytest.mark.parametrize("activation", ["leaky_relu", "elu", "none"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", EMU_CASES, ids=_case_id)
def test_blocked_abn_bwd_sums_match_plain(case, dtype, activation):
    """B3's terms as the kernel forms them in fp32 (times 1/slope; gamma
    out of the sum, which is divided by it once per channel), summed in the
    plan's order, against the plain version, which divides every term."""
    shape, layout, aligned = case
    plan = kernels.reduce_plan(shape, dtype, _inner(shape, layout), aligned, 132, True)
    rng = np.random.default_rng(1)
    c = shape[1]
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(np.float32))
    z = abn.act_forward(_input(rng, shape, torch.float32, 0.0, 1.0), activation,
                        SLOPE).to(dtype).float()
    g = _input(rng, shape, dtype, 0.0, 1.0)
    view = (1, c) + (1,) * (len(shape) - 2)
    inv_slope = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(SLOPE, dtype=torch.float32)
    neg = z < 0
    dy, y = g.clone(), z.clone()
    if activation == "leaky_relu":
        dy = torch.where(neg, g * torch.tensor(SLOPE, dtype=torch.float32), g)
        y = torch.where(neg, z * inv_slope, z)
    elif activation == "elu":
        dy = torch.where(neg, g * (z + 1.0), g)
        y = torch.where(neg, torch.log1p(z), z)
    edz, gamma_eydz = _emulate(plan, dy, (y - beta.view(view)) * dy)
    got = (edz.astype(np.float32), (gamma_eydz / gamma.numpy().astype(edz.dtype)).astype(np.float32))
    want = abn.abn_bwd_sums_plain(z, g, gamma, beta, activation, SLOPE)
    dims = (0,) + tuple(range(2, len(shape)))
    xhat = (y - beta.view(view)) / gamma.view(view)
    magnitude = (dy.abs().sum(dims), (xhat * dy).abs().sum(dims))
    for gt, w, m, what in zip(got, want, magnitude, ("edz", "eydz")):
        _assert_close(gt, w.numpy(), m.numpy(), what)


# ---------------------------------------------------------------------------
# segtpu_torch.profile_reduce: its shapes and its error measure, on the CPU
# ---------------------------------------------------------------------------

def test_profile_reduce_finds_the_step_norm_shapes():
    from segtpu_torch.profile_reduce import step_norm_shapes

    shapes = step_norm_shapes(batch=2, patch=64, device="cpu")
    scaled = {(16,) + (s[1],) + tuple(d * 8 for d in s[2:]) for s in shapes["bn"] + shapes["abn"]}
    assert scaled == set(STEP_SHAPES)


@pytest.mark.parametrize("kernel", ["b1_single", "b1_pair", "b3_leaky_relu"])
def test_profile_reduce_errors_against_float64(kernel):
    """On CPU tensors the dispatching functions run the plain versions, so
    both columns measure fp32 sums of bf16 inputs against float64 ones."""
    from segtpu_torch import profile_reduce as pr

    g = torch.Generator().manual_seed(0)
    shape = (4, 16, 12, 12)
    if kernel == "b3_leaky_relu":
        inputs = pr.b3_inputs(shape, g, device="cpu")
        errs = pr.b3_errors(*inputs)
    else:
        inputs = pr.b1_inputs(shape, kernel == "b1_pair", g, device="cpu")
        errs = pr.b1_errors(*inputs)
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for t in inputs if t is not None and t.dim() == 4)
    assert inputs[0].dtype == torch.bfloat16
    assert set(errs) == {"kernel", "plain_fp32"}
    assert errs["kernel"] == errs["plain_fp32"]
    assert 0.0 < errs["kernel"] < 1e-6
