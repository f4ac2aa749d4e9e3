"""Each plain reference against segtpu_torch in fp32 at small sizes on the
CPU (this test imports both; the references import neither), and the
configurations' counted work recomputed from the references."""

import numpy as np
import pytest
import torch

from segbench import counts, harness
from segbench.reference import numerics, tiled

CPU = torch.device("cpu")
MODELS = {"linknet34": 64, "tiramisu67": 64}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(name: str, seed: int = 5):
    """(port model, reference model) with the benchmark's seeded weights."""
    from segtpu_torch.models import get_model

    conf = harness.config(name)
    port = get_model(conf["model"], patch_size=MODELS[name], device="cpu")
    state = harness.seeded_state(port.state_dict(), seed, CPU)
    port.load_state_dict(state)
    ref = numerics.build(harness.reference_class(conf), CPU, state, numerics.Numerics())
    return port, ref


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_names_and_shapes(name):
    port, ref = _pair(name)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_seeded_state_is_the_same_from_either_model(name):
    port, ref = _pair(name)
    a = harness.seeded_state(port.state_dict(), 9, CPU)
    b = harness.seeded_state(ref.state_dict(), 9, CPU)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_forward_agrees(name):
    port, ref = _pair(name)
    port.eval(), ref.eval()
    x = torch.randn(2, 3, MODELS[name], MODELS[name], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(x), ref(x)
    scale = b.abs().max()
    assert float((a - b).abs().max() / scale) < 1e-4


@pytest.mark.parametrize("cell", ["tiramisu67.train-512-b4", "linknet34.train-512-b16"])
def test_training_steps_agree(cell):
    """Three fp32 steps of the port's make_train_step and of the reference,
    from the same weights, batches and dropout masks. Under Adam a weight
    whose gradient is near nought moves by about lr whatever its sign, so
    the change, and the losses of the steps after the first, are held more
    loosely there than the first gradient."""
    kind = harness.traffic_kind("train_steps")
    conf = harness.config(harness.workload(cell)["config"])
    ctx = harness.Context(cell, 11, 0.0, False, CPU, overrides={
        "config": {"train": dict(conf["train"], bf16=False)},
        "traffic": {"batch": 2, "patch": MODELS[conf["name"]], "pool": 3}})
    from segbench import shapes

    batches = shapes.pool(3, 2, MODELS[conf["name"]], ctx.seed, CPU)
    step, model, opt = kind.build_program(ctx)
    got = kind.warm_steps(ctx, step, model, opt, batches)
    ref = kind.reference(ctx, batches)
    adam = conf["train"]["optimizer"] == "adam"
    limits = {"loss_gap": 1e-3 if adam else 1e-5, "grad_gap": 2e-3,
              "change_gap": 5e-2 if adam else 2e-3}
    checks = kind.compare(got, ref, limits)
    assert all(harness.passed(c) for c in checks.values()), checks


@pytest.mark.parametrize("tta", [True, False])
def test_tiled_probabilities_agree(tta):
    from segtpu_torch.augment import host as aug
    from segtpu_torch.inference import predict_tiled
    from segtpu_torch.train.state import make_predict_step

    port, ref = _pair("linknet34")
    port.eval(), ref.eval()
    norm = harness.config("linknet34")["serve"]["normalize"]
    image = np.random.default_rng(3).integers(0, 256, (150, 170, 3), dtype=np.uint8)
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(
        scale=norm["scale"], mean=norm["mean"], std=norm["std"]))])
    got = predict_tiled(image, make_predict_step(port), transform, patch_size=64, batch_size=16,
                        tta=tta, weight="pyramid", device="cpu")
    with torch.no_grad():
        want = tiled.probabilities(lambda x: torch.sigmoid(ref(x)), image, norm, 64, tta, 3, CPU)
    assert np.abs(got - want.numpy()).max() < 1e-5


def test_geometry_matches_the_port():
    from segtpu_torch.tiles import ImageSlicer, compute_pyramid_weight

    for size, patch in ((5000, 512), (150, 64), (170, 64), (512, 512)):
        s = ImageSlicer((size, size, 3), patch, patch // 2, weight="pyramid")
        (top, bottom, left, right), crops = tiled.geometry(size, size, patch)
        assert (top, bottom, left, right) == (s.margin_top, s.margin_bottom, s.margin_left,
                                              s.margin_right)
        assert crops == [(y, x) for x, y, _, _ in s.crops]
    assert np.allclose(tiled.pyramid_weight(64), compute_pyramid_weight(64, 64)[0], rtol=1e-12)
    assert tiled.tiles_per_image(5000, 5000, 512) == 361


@pytest.mark.parametrize("name", ["linknet34", "tiramisu67"])
def test_counts_match_the_configuration(name):
    conf = harness.config(name)
    assert counts.count(conf, conf["counts"]["patch"]) == conf["counts"]


def test_counts_match_the_ports_figures():
    """The port's own roofline counted 2216.1 and 2600.0 GFLOP per step at
    batch 16 and 4, and 46.58 GFLOP per 512^2 forward."""
    link, tira = harness.config("linknet34")["counts"], harness.config("tiramisu67")["counts"]
    assert round(16 * link["train_gflop_per_image"], 1) == 2216.1
    assert round(4 * tira["train_gflop_per_image"], 1) == 2600.0
    assert round(link["serve_gflop_per_view"], 2) == 46.58
    # the bound of one 64-view serving pass of B2: 0.649 ms at 3.35 TB/s
    assert round(64 * link["b2_bytes_per_view"] / 3.35e12 * 1e3, 3) == 0.649
