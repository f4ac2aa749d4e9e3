"""Each plain reference against segtpu_torch in fp32, and the training
steps in float64 too, at small sizes on the CPU (this test imports both;
the references import neither), and the
configurations' counted work recomputed from the references."""

import numpy as np
import pytest
import torch

from segbench import counts, harness
from segbench.reference import numerics, tiled

CPU = torch.device("cpu")
MODELS = {"linknet34": 64, "tiramisu67": 64, "zf_unet": 64, "albunet_finetune": 128}
ALBUNET = "albunet_finetune.train-512-b64"
TRAIN_CELLS = ["tiramisu67.train-512-b4", "linknet34.train-512-b16", "zf_unet.train-512-b16",
               "zf_unet.train-512-b16-s2d", ALBUNET]
ZF_CELLS = ("zf_unet.train-512-b16", "zf_unet.train-512-b16-s2d")
# ZF_UNET's worst leaves in fp32 lie at its top level (the first conv's
# weight, the top BatchNorms' weights and biases), whose first gradients sum
# terms that cancel: the sum of their magnitudes is 50-100 times the sum's
# at 2x64^2, 100-280 times at 2x256^2, against 5-9 times for the median
# leaf. There the reference's own fp32 steps drift from its float64 steps
# by as much as the program's fp32 steps drift from the reference (about
# 1e-3 of the first gradient, 1e-2 of the change after three steps), while
# in float64 the two agree to 1e-12 (test_training_steps_agree_in_float64):
# the median leaf is held tightly, the worst leaf and the losses more
# loosely.
ZF_LIMITS = {"loss_gap": 1e-4, "logit_gap": 1e-4, "grad_median_gap": 1e-3,
             "change_median_gap": 1e-3, "grad_gap": 2e-2, "change_gap": 5e-2}


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


@pytest.mark.parametrize("cell", TRAIN_CELLS)
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
    if conf["train"].get("freeze_encoder"):
        limits["frozen_change"] = 0.0
    checks = kind.compare(got, ref, ZF_LIMITS if cell in ZF_CELLS else limits)
    assert all(harness.passed(c) for c in checks.values()), checks


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_steps_agree_in_float64(cell):
    """The same three steps with the program and the reference both in
    float64: with rounding all but gone, every leaf agrees, the worst one
    included. So where the worst leaf's gap is wide in fp32 (ZF_UNET's top
    level), it comes from rounding that the step amplifies, not from a
    difference in the maths. Under Adam, and through InPlaceABN's backward
    from its output, the gaps stay above float64's rounding, and are held
    more loosely."""
    from segbench import shapes
    from segbench.reference import train as ref_train

    f64 = torch.float64
    kind = harness.traffic_kind("train_steps")
    conf = harness.config(harness.workload(cell)["config"])
    patch = MODELS[conf["name"]]
    ctx = harness.Context(cell, 11, 0.0, False, CPU, overrides={
        "config": {"train": dict(conf["train"], bf16=False)},
        "traffic": {"batch": 2, "patch": patch, "pool": 3}})
    batches = [(x.to(f64), y.to(f64)) for x, y in shapes.pool(3, 2, patch, ctx.seed, CPU)]
    step, model, opt = kind.build_program(ctx)
    got = kind.warm_steps(ctx, step, model.to(f64), opt, batches)

    nx = numerics.Numerics(mask_dtype=f64)
    cls = harness.reference_class(conf)
    with torch.device("meta"):
        template = cls(nx).state_dict()
    state = {k: v.to(f64) if v.is_floating_point() else v
             for k, v in harness.seeded_state(template, ctx.seed, CPU).items()}
    ref = ref_train.run_steps(numerics.build(cls, CPU, state, nx).to(f64), batches,
                              conf["train"], ctx.seed, nx, ref_train.frozen_prefixes(conf))
    assert got["logits"].dtype == ref["logits"].dtype == f64
    adam = conf["train"]["optimizer"] == "adam"
    limits = {"loss_gap": 1e-8 if adam else 1e-12, "logit_gap": 1e-10,
              "grad_gap": 1e-8 if adam else 1e-10, "change_gap": 1e-7 if adam else 1e-10}
    if conf["train"].get("freeze_encoder"):
        limits["frozen_change"] = 0.0
    checks = kind.compare(got, ref, limits)
    assert all(harness.passed(c) for c in checks.values()), checks


def _zf_context(cell: str, seed: int, **traffic) -> harness.Context:
    conf = harness.config("zf_unet")
    return harness.Context(cell, seed, 0.0, False, CPU, overrides={
        "config": {"train": dict(conf["train"], bf16=False)},
        "traffic": dict({"batch": 2, "patch": 64, "pool": 3}, **traffic)})


def test_s2d_and_normal_forms_agree():
    """The s2d cell's program runs ZF_UNET in its s2d form, the normal cell's
    in normal space; from the same weights and batches their first steps
    agree to fp32 rounding, dropout included (one mask per true channel,
    drawn as normal space draws it)."""
    from segbench import shapes

    kind = harness.traffic_kind("train_steps")
    got = {}
    for cell in ZF_CELLS:
        ctx = _zf_context(cell, 13)
        batches = shapes.pool(3, 2, 64, ctx.seed, CPU)
        step, model, opt = kind.build_program(ctx)
        assert model.s2d == cell.endswith("-s2d")
        got[cell] = kind.warm_steps(ctx, step, model, opt, batches)
    normal, s2d = ZF_CELLS
    checks = kind.compare(got[s2d], got[normal], ZF_LIMITS)
    assert all(harness.passed(c) for c in checks.values()), checks


def test_s2d_cell_runs_within_its_limits_against_the_normal_reference():
    """Both cells through ``run_cell``: the s2d cell's first steps come out
    within its limits, and the reference that judges them is the one that
    judges the normal cell."""
    seen = {}

    def capture(cell):
        def hook(kind):
            reference = kind.reference

            def traced(ctx, batches, precision="fp32"):
                seen[cell] = reference(ctx, batches, precision)
                return seen[cell]

            kind.reference = traced

        return hook

    conf = harness.config("zf_unet")
    overrides = {"config": {"train": dict(conf["train"], bf16=False)},
                 "traffic": {"batch": 2, "patch": 64, "pool": 4}}
    for cell in ZF_CELLS:
        result = harness.run_cell(cell, 2 ** 31 + 19, 0.3, False, CPU, overrides=overrides,
                                  kind_hook=capture(cell))
        assert result["correct"] and result["attempted"] >= 1, result["checks"]
        assert set(result["checks"]) == set(harness.workload(cell)["limits"])
    normal, s2d = ZF_CELLS
    assert seen[normal]["losses"] == seen[s2d]["losses"]
    assert torch.equal(seen[normal]["logits"], seen[s2d]["logits"])


@pytest.mark.parametrize("model, form", [("gcn34", "s2d"), ("zf_unet", "space_to_depth")])
def test_a_form_the_model_lacks_is_refused(model, form):
    kind = harness.traffic_kind("train_steps")
    ctx = _zf_context("zf_unet.train-512-b16-s2d", 1, form=form)
    ctx.config = dict(ctx.config, model=model)
    with pytest.raises(ValueError):
        kind.build_program(ctx)


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


@pytest.mark.parametrize("name", sorted(MODELS))
def test_counts_match_the_configuration(name):
    conf = harness.config(name)
    assert counts.count(conf, conf["counts"]["patch"]) == conf["counts"]


def test_counts_match_the_ports_figures():
    """The port's own roofline counted 2216.1, 2600.0 and 6625.3 GFLOP per
    step at batch 16, 4 and 16, and 46.58 GFLOP per 512^2 forward."""
    link, tira = harness.config("linknet34")["counts"], harness.config("tiramisu67")["counts"]
    zf = harness.config("zf_unet")["counts"]
    assert round(16 * link["train_gflop_per_image"], 1) == 2216.1
    assert round(4 * tira["train_gflop_per_image"], 1) == 2600.0
    assert round(16 * zf["train_gflop_per_image"], 1) == 6625.3
    assert round(link["serve_gflop_per_view"], 2) == 46.58
    # the bound of one 64-view serving pass of B2: 0.649 ms at 3.35 TB/s
    assert round(64 * link["b2_bytes_per_view"] / 3.35e12 * 1e3, 3) == 0.649


def _albunet_context(seed: int) -> harness.Context:
    conf = harness.config("albunet_finetune")
    return harness.Context(ALBUNET, seed, 0.0, False, CPU, overrides={
        "config": {"train": dict(conf["train"], bf16=False)},
        "traffic": {"batch": 2, "patch": 128, "pool": 3}})


def _bn_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_mean")}


def test_frozen_leaves_stay_bit_unchanged_while_their_batchnorms_update():
    """Three steps of the frozen recipe: in the program and in the reference
    every encoder parameter keeps its bits, every decoder parameter moves,
    and the encoder's BatchNorms update their running statistics."""
    from segbench import shapes
    from segbench.reference import train as ref_train

    kind = harness.traffic_kind("train_steps")
    ctx = _albunet_context(23)
    batches = shapes.pool(3, 2, 128, ctx.seed, CPU)
    step, model, opt = kind.build_program(ctx)
    ref_model = numerics.build(harness.reference_class(ctx.config), CPU,
                               {k: v.clone() for k, v in model.state_dict().items()},
                               numerics.Numerics())
    prefixes = ref_train.frozen_prefixes(ctx.config)
    assert prefixes == ("encoder.",)
    for m, run in ((model, lambda: kind.warm_steps(ctx, step, model, opt, batches)),
                   (ref_model, lambda: ref_train.run_steps(ref_model, batches, ctx.config["train"],
                                                           ctx.seed, numerics.Numerics(),
                                                           prefixes))):
        params = {n: p.detach().clone() for n, p in m.named_parameters()}
        stats = _bn_stats(m)
        run()
        for n, p in m.named_parameters():
            if n.startswith(prefixes):
                assert torch.equal(p.detach(), params[n]), n
            else:
                assert not torch.equal(p.detach(), params[n]), n
        assert len(stats) == 36 and all(n.startswith("encoder.") for n in stats)
        after = _bn_stats(m)
        assert all(not torch.equal(after[n], stats[n]) for n in stats)


def test_encoder_prefixes_select_the_ports_frozen_names():
    """The configuration's ``encoder_prefixes`` freeze exactly the parameters
    that the port's ``without_encoder`` leaves out of training."""
    from segbench.reference import train as ref_train
    from segtpu_torch.models import get_model, without_encoder

    conf = harness.config("albunet_finetune")
    names = [n for n, _ in get_model(conf["model"], patch_size=128, device="cpu")
             .named_parameters()]
    trained = without_encoder(conf["model"], names)
    frozen = {n for n in names if n.startswith(ref_train.frozen_prefixes(conf))}
    assert frozen == set(names) - trained
    assert (len(frozen), len(trained)) == (108, 28)


@pytest.mark.parametrize("freeze", [True, False])
def test_frozen_count_equals_a_count_of_the_port(freeze):
    """``train_gflop_per_image`` under the freeze is a FlopCounterMode count
    of the port's AlbuNet with its encoder's ``requires_grad_(False)``, and
    without it the full backward's; at 512^2 they are 242.5 and 318.1."""
    from torch.utils.flop_counter import FlopCounterMode

    from segtpu_torch.models import get_model

    conf = harness.config("albunet_finetune")
    if not freeze:
        conf = dict(conf, train=dict(conf["train"], freeze_encoder=False))
    port = get_model(conf["model"], patch_size=128, device="cpu")
    port.encoder.requires_grad_(not freeze)
    port.train()
    with FlopCounterMode(display=False) as flops:
        port(torch.zeros(1, 3, 128, 128)).sum().backward()
    got = counts.count(conf, 128)
    assert got["train_gflop_per_image"] == flops.get_total_flops() / 1e9
    assert ("bn_reduce_bytes_per_image" in got) == freeze
    if freeze:
        # 36 encoder BatchNorms, none of which needs a backward: one read each
        assert got["bn_reduce_bytes_per_image"] == got["bn_input_bytes_per_image"]
    full = counts.count(conf, 512)["train_gflop_per_image"]
    assert round(full, 1) == (242.5 if freeze else 318.1)


def test_compared_keys():
    """The numbers a training check can compare: the six keys of every
    cell, and ``frozen_change`` only where the reference froze parameters,
    which no configuration but the finetune's does."""
    from segbench.reference import train as ref_train

    assert {name: ref_train.frozen_prefixes(harness.config(name)) for name in MODELS} == \
        {"linknet34": (), "tiramisu67": (), "zf_unet": (), "albunet_finetune": ("encoder.",)}
    kind = harness.traffic_kind("train_steps")
    leaves = {"a": 1.0, "b": 2.0, "c": 3.0}
    program = {"losses": [1.0], "logits": torch.ones(2), "grad": leaves, "change": leaves,
               "norm": leaves}
    ref = {"losses": [1.0], "logits": torch.ones(2), "grad": leaves, "change": leaves,
           "frozen": []}
    keys = {"loss_gap", "logit_gap", "grad_gap", "grad_median_gap", "change_gap",
            "change_median_gap"}
    assert set(kind.gaps(program, ref)) == keys
    frozen = dict(ref, grad={"a": 1.0, "b": 2.0}, change={"a": 1.0, "b": 2.0}, frozen=["c"])
    values = kind.gaps(program, frozen)
    assert set(values) == keys | {"frozen_change"} and values["frozen_change"] == 1.0
    assert kind.gaps(dict(program, change=dict(leaves, c=0.0)), frozen)["frozen_change"] == 0.0
