"""The port's roofline and floors (segtpu_torch.roofline, tiled_floor, bn_sol,
tiramisu_floor) against segtpu's tools and an analytic count, on the CPU.

The model FLOP count of a training step (``roofline.step_flops``) is held to
an analytic sum over the convolutions of the model, ``2 * Cin/groups * Cout *
kh * kw * N * (output pixels; input pixels for a transposed conv)`` for the
forward, again for the data gradient where the conv's input needs one, and
again for the weight gradient where the weight trains: exactly, for a narrow
UNet, LinkNet34 with and without its frozen encoder and ZF_UNET in both
forms. ``tiramisu_floor`` equals segtpu's ``tools/tiramisu_floor.analyze``,
``bn_sol``'s sites segtpu's ``collect_bn_sites``, and ``tiled_floor``'s tiles
and passes segtpu's ``ImageSlicer``'s. Small shapes throughout.
"""

import math
import os
import sys
from collections import Counter

import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from segtpu.tiles import ImageSlicer as JaxImageSlicer  # noqa: E402
from tools import bn_sol as jax_bn_sol  # noqa: E402
from tools import tiramisu_floor as jax_tiramisu_floor  # noqa: E402

from segtpu_torch import bn_sol, roofline, tiled_floor, tiramisu_floor  # noqa: E402
from segtpu_torch.models import ENCODER_PREFIXES, get_model  # noqa: E402
from segtpu_torch.models.unet import UNet  # noqa: E402
from segtpu_torch.ops import abn as abn_ops  # noqa: E402

PATCH = 64


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def analytic_step_flops(model, patch, batch):
    """The analytic count of the module docstring over ``model``'s convs
    (run once at batch 1 for their shapes, times ``batch``); also the part
    of it from each conv by name."""
    seen = []

    def hook(name):
        def record(mod, inp, out):
            seen.append((name, mod, inp[0].shape, inp[0].requires_grad, out.shape))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    model(torch.randn(1, 3, patch, patch)).float().sum().backward()
    for h in handles:
        h.remove()
    per_conv = {}
    for name, mod, x_shape, x_grad, y_shape in seen:
        transposed = isinstance(mod, torch.nn.ConvTranspose2d)
        cin, cout = mod.in_channels, mod.out_channels
        pixels = math.prod((x_shape if transposed else y_shape)[2:])
        fwd = 2 * cin // mod.groups * cout * math.prod(mod.kernel_size) * pixels * batch
        passes = 1 + int(x_grad) + int(mod.weight.requires_grad)
        per_conv[name] = per_conv.get(name, 0) + fwd * passes
    return sum(per_conv.values()), per_conv


def _twin(name, freeze=False, model=None):
    return roofline.flop_twin(name, PATCH, "cpu", 0, freeze, model)


@pytest.mark.parametrize("name,freeze,batch", [
    ("unet_narrow", False, 3), ("linknet34", False, 2), ("linknet34", True, 2),
    ("zf_unet", False, 1)])
def test_step_flops_equals_the_analytic_conv_count(name, freeze, batch):
    built = UNet(3, 1, n_filters=8) if name == "unet_narrow" else None
    model_name = "unet" if built is not None else name
    got = roofline.step_flops(model_name, PATCH, batch, freeze, "cpu", model=built)
    want, _ = analytic_step_flops(_twin(model_name, freeze,
                                        UNet(3, 1, n_filters=8) if built is not None else None),
                                  PATCH, batch)
    assert got == want and got > 0


def test_frozen_encoder_drops_exactly_the_encoders_gradients():
    """LinkNet34 trained whole against with its encoder frozen: the count
    falls by each encoder conv's data and weight gradient and by the data
    gradient into the encoder's output (decoder4's first conv reads it
    alone), no more."""
    full, per_full = analytic_step_flops(_twin("linknet34"), PATCH, 2)
    frozen, per_frozen = analytic_step_flops(_twin("linknet34", True), PATCH, 2)
    encoder = [n for n in per_full if (n + ".").startswith(ENCODER_PREFIXES["linknet34"])]
    assert encoder and set(per_full) == set(per_frozen)
    lost_dgrad = []
    for n in per_full:
        if n in encoder:
            # every encoder conv runs its forward only; the first had no dgrad before
            assert per_frozen[n] * (2 if n == encoder[0] else 3) == per_full[n], n
        elif per_frozen[n] != per_full[n]:
            assert per_frozen[n] * 3 == per_full[n] * 2, n
            lost_dgrad.append(n)
    assert lost_dgrad == ["decoder4.conv1"]
    assert roofline.step_flops("linknet34", PATCH, 2, False) == full
    assert roofline.step_flops("linknet34", PATCH, 2, True) == frozen < full


def test_s2d_and_normal_forms_report_the_same_model_flops():
    """zf_unet in its s2d form and in normal space: one GFLOP per step (the
    normal-space twin's), each run labelled with its form."""
    rows = [roofline.analyze(model_name="zf_unet", patch=PATCH, batch_size=2, loss_name="bce",
                             optimizer="sgd", s2d=s2d, steps=1, warmup=0, device="cpu",
                             with_bytes=False) for s2d in (True, False)]
    assert [r["form"] for r in rows] == ["s2d", "normal"]
    assert rows[0]["gflop_per_step"] == rows[1]["gflop_per_step"] > 0
    assert all(r["mfu_pct"] is None and r["device"] == "cpu" for r in rows)
    assert roofline.step_args("zf_unet-512")["s2d"] is True
    assert roofline.step_args("zf_unet-512", no_s2d=True)["s2d"] is False


def test_the_count_ignores_the_kernels_and_remat():
    """B1/B2/B3 run inside the counted step but add nothing (the count is
    the analytic conv count); a remat model recomputes its forward, which a
    plain count would add, and the twin turns remat off."""
    calls = Counter()
    dispatch = abn_ops._on_device

    def counting(name, x, cuda_fn, plain_fn, *args):
        calls[name] += 1
        return dispatch(name, x, cuda_fn, plain_fn, *args)

    abn_ops._on_device = counting
    try:
        got = roofline.step_flops("linknet34", PATCH, 1)
    finally:
        abn_ops._on_device = dispatch
    assert calls == {"channel_sums": 84, "abn_norm_act": 48, "abn_bwd_sums": 12}
    assert got == analytic_step_flops(_twin("linknet34"), PATCH, 1)[0]

    remat = get_model("zf_unet", patch_size=PATCH, device="cpu").train()
    remat.remat = True
    plain_count = roofline.count_flops(remat, torch.randn(1, 3, PATCH, PATCH))
    assert plain_count > roofline.step_flops("zf_unet", PATCH, 1)


def test_card_peaks_need_a_known_card_or_a_given_peak():
    assert roofline.card_peaks("NVIDIA H100 80GB HBM3")[:2] == (989e12, 3.35e12)
    with pytest.raises(SystemExit, match="--peak-tflops"):
        roofline.card_peaks("NVIDIA H100 PCIe")
    assert roofline.card_peaks("NVIDIA H100 PCIe", 756.0, 2000.0)[:2] == (756e12, 2000e9)


def test_step_bytes_charge_each_kernel_call_from_its_shapes():
    step, x, y, _, _ = roofline.bench.build_train_step(
        2, PATCH, model_name="linknet34", loss_name="bce_jaccard", optimizer="adam",
        device="cpu")
    moved = roofline.step_bytes(step, x, y)
    assert moved["kernel_calls"] == 84 + 48 + 12
    assert moved["ops"] > 0 and moved["ops_bytes"] > moved["kernel_bytes"] > 0
    a = torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16)
    assert roofline.kernel_bytes("channel_sums", a) == a.nbytes + 2 * 4 * 16
    assert roofline.kernel_bytes("channel_sums", a, a) == 2 * a.nbytes + 2 * 4 * 16
    scale = torch.zeros(16)
    assert roofline.kernel_bytes("abn_norm_act", a, scale, scale, "none", 0.0) == \
        2 * a.nbytes + 2 * scale.nbytes


def test_roofline_cli_prints_a_row(capsys):
    roofline.main(["--model", "unet", "--patch", "32", "--batch", "1", "--steps", "1",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"gflop_per_step"' in out and '"device": "cpu"' in out


@pytest.mark.parametrize("model", sorted(tiramisu_floor.ARCH))
@pytest.mark.parametrize("patch,batch", [(224, 16), (512, 4)])
def test_tiramisu_floor_equals_segtpu(model, patch, batch):
    """The same bytes and, at segtpu's 819 GB/s, the same times, rounded as
    segtpu rounds them."""
    want = jax_tiramisu_floor.analyze(model, patch, batch, 2.0)
    got = tiramisu_floor.analyze(model, patch, batch, 2.0, hbm_gbs=819.0)
    assert tiramisu_floor.ARCH[model] == jax_tiramisu_floor.ARCH[model]
    for key, value in want.items():
        assert (got[key] if isinstance(value, str) or key in ("patch", "batch")
                else round(got[key], 1)) == value, key


@pytest.fixture
def abstract_segtpu_state(monkeypatch):
    """segtpu's train state made by ``jax.eval_shape``: collect_bn_sites only
    traces the step abstractly, and a real LinkNet34 init takes seconds."""
    import segtpu.train.state as state

    create = state.create_train_state
    monkeypatch.setattr(state, "create_train_state", lambda model, tx, shape, *a, **k:
                        jax.eval_shape(lambda: create(model, tx, shape, *a, **k)))


@pytest.mark.parametrize("model", ["zf_unet", "linknet34"])
def test_bn_sol_sites_equal_segtpus(model, abstract_segtpu_state):
    want = jax_bn_sol.collect_bn_sites(model, PATCH, 2)
    got = bn_sol.bn_sites(model, PATCH, 2)
    assert {d for _, d, _ in want} == {"bfloat16"}
    assert Counter(got) == Counter(((s[0], s[3], s[1], s[2]), b) for s, _, b in want)
    light = bn_sol.sol(got)
    assert light["sites"] == len(want)
    assert light["reduce_read_gb"] == pytest.approx(3 * sum(b for *_, b in want) / 1e9, rel=1e-12)


def test_bn_sol_bound_arithmetic():
    b = bn_sol.bound(step_ms=60.0, reduce_ms=10.0, sol_ms=1.5, batch=16)
    assert b["step_bound_ms"] == 51.5
    assert b["img_per_s_bound"] == pytest.approx(16 / 51.5e-3)


@pytest.mark.parametrize("size,patch,batch", [(5000, 512, 64), (300, 64, 16)])
def test_tiled_floor_counts_equal_segtpus_slicer(size, patch, batch):
    geom = tiled_floor.geometry(size, patch, batch)
    slicer = JaxImageSlicer((size, size, 3), patch, patch // 2)
    chunk = max(1, batch // 8)
    n_chunks = -(-len(slicer.crops) // chunk)
    assert geom["tiles"] == len(slicer.crops)
    assert (geom["chunk"], geom["chunks"]) == (chunk, n_chunks)
    assert geom["passes_executed"] == n_chunks * chunk * 8
    assert geom["passes_needed"] == len(slicer.crops) * 8
    assert geom["canvas"][:2] == list(slicer.target_shape)
    if size == 5000:
        assert (geom["tiles"], geom["passes_needed"], geom["passes_executed"]) == (361, 2888, 2944)


def test_tiled_floor_bound_on_the_cpu():
    row = tiled_floor.analyze(patch=32, image_size=100, batch=16, model_name="linknet34",
                              device="cpu", peak_tflops=989.0, peak_hbm_gbs=3350.0,
                              measured_s_per_image=1.0)
    flops = row["passes_needed"] * roofline.forward_flops("linknet34", 32)
    assert row["tflop_per_image"] * 1e12 == pytest.approx(flops, rel=1e-12)
    assert row["t_flop_bound_s"] == pytest.approx(flops / 989e12, rel=1e-12)
    assert row["t_hbm_bound_s"] == pytest.approx(
        tiled_floor.merge_bytes(row, 32) / 3350e9, rel=1e-12)
    assert row["floor_s_per_image"] == max(row["t_flop_bound_s"], row["t_hbm_bound_s"])
    assert row["t_transfer_s"] is None and row["card"] == "cpu"
