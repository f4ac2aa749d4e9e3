"""The profiled stretch's reduction and the metric readers' arithmetic, from
made-up intervals and records."""

import pytest

from segbench import harness, trace

MS = 1_000_000  # ns


def test_reduce_busy_gaps_groups_and_labels():
    spans = [(trace.STRETCH, 0, 100 * MS), ("segbench.step", 0, 60 * MS),
             ("segbench.pass", 10 * MS, 35 * MS)]
    device = [("SumsOp<float>", 5 * MS, 15 * MS), ("abn_norm_act_kernel", 12 * MS, 20 * MS),
              ("elementwise_kernel", 40 * MS, 52 * MS), ("AbnBwdOp", 95 * MS, 120 * MS),
              ("rows_pass<BnDxOp, __nv_bfloat16, 8>", 41 * MS, 45 * MS),
              ("before", -10 * MS, -5 * MS)]
    out = trace.reduce(device, spans)
    assert out["window_s"] == pytest.approx(0.1)
    # [5, 20] + [40, 52] + [95, 100] inside the window
    assert out["busy_s"] == pytest.approx(0.032)
    assert out["kernel_s"] == pytest.approx({"B1": 0.010, "B2": 0.008, "B3": 0.005,
                                             "dx": 0.004})
    # the BatchNorm dx pass has a group of its own, not "other"
    assert out["groups_s"]["BatchNorm dx pass"] == pytest.approx(0.004)
    assert "other" not in out["groups_s"]
    gaps = out["breakdown"]["idle_gaps"]
    # [52, 95] opens in segbench.step and mostly lies after it: its midpoint rules
    assert gaps[0] == ["outside any span", pytest.approx(0.043)]
    assert gaps[1] == ["segbench.pass", pytest.approx(0.020)]
    assert gaps[2] == ["segbench.step", pytest.approx(0.005)]
    assert out["breakdown"]["device_ops"][0] == ["elementwise", pytest.approx(0.012)]


def test_reduce_needs_the_stretch_span():
    with pytest.raises(ValueError):
        trace.reduce([], [("segbench.step", 0, 1)])


def _record(**kw):
    rec = {"config": harness.config("tiramisu67"), "traffic": harness.traffic("train-512-b4"),
           "peaks": harness.peaks("NVIDIA H100 80GB HBM3")}
    rec.update(kw)
    return rec


def test_training_readers():
    train = {"steps": 100, "images": 400, "window_ms": 16000.0,
             "step_ms": [150.0] * 90 + [200.0] * 10, "batch": 4}
    tr = {"busy_s": 0.75, "window_s": 1.2, "device_events": 10, "steps": 5,
          "kernel_s": {"B1": 0.04, "B2": 0.02, "B3": 0.0}}
    rec = _record(train=train, trace=tr, peak_bytes=2 ** 34)
    read = harness.metric_reader
    assert read("train_images_per_s")(rec) == pytest.approx(25.0)
    assert read("train_step_p95_ms")(rec) == pytest.approx(200.0)
    assert read("peak_mem_gib")(rec) == pytest.approx(16.0)
    flops = 649.993519104e9 * 400 / 16.0
    assert read("mfu_pct.train")(rec) == pytest.approx(100 * flops / 989e12)
    # busy 0.15 s per step of 0.16 s
    assert read("device_idle_pct.train")(rec) == pytest.approx(100 * (1 - 0.15 / 0.16))
    nbytes = 3 * 1409859584 * 4 * 5
    assert read("bn_reduce_roofline.train")(rec) == pytest.approx(100 * nbytes / 3.35e12 / 0.04)
    assert read("serve_s_per_image")(rec) is None and read("b2_roofline.serve")(rec) is None


def test_bn_reduce_roofline_counts_the_reads_the_step_needs():
    """A configuration that freezes its encoder counts one read of each
    BatchNorm input whose backward is not needed (its
    ``bn_reduce_bytes_per_image``); the others three reads of every input."""
    tr = {"busy_s": 0.5, "window_s": 0.8, "device_events": 10, "steps": 10,
          "kernel_s": {"B1": 0.02, "B2": 0.01, "B3": 0.0}}
    train = {"steps": 100, "images": 6400, "window_ms": 10000.0, "step_ms": [100.0] * 100,
             "batch": 64}
    read = harness.metric_reader("bn_reduce_roofline.train")
    frozen = _record(config=harness.config("albunet_finetune"),
                     traffic=harness.traffic("train-512-b64"), train=train, trace=tr)
    assert read(frozen) == pytest.approx(100 * 39059456 * 64 * 10 / 3.35e12 / 0.02)
    conf = harness.config("albunet_finetune")
    counts = {k: v for k, v in conf["counts"].items() if k != "bn_reduce_bytes_per_image"}
    full = dict(frozen, config=dict(conf, counts=counts))
    assert read(full) == pytest.approx(3 * read(frozen))


FAMILIES = {f"{plain.split('.')[0]}.{family}": plain
            for family in ("hostbound", "launchbound")
            for plain in ("train_images_per_s", "mfu_pct.train", "bn_reduce_roofline.train",
                          "device_idle_pct.train")}
FAMILIES["train_step_p95_ms.hostbound"] = "train_step_p95_ms"


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_readers_read_as_the_plain_ones(name):
    # the readers of a family read the plain metric: they differ only in
    # the bound or the layer it is held under
    train = {"steps": 100, "images": 1600, "window_ms": 7000.0,
             "step_ms": [60.0] * 90 + [90.0] * 10, "batch": 16}
    tr = {"busy_s": 0.35, "window_s": 0.8, "device_events": 10, "steps": 10,
          "kernel_s": {"B1": 0.014, "B2": 0.007, "B3": 0.003}}
    rec = _record(train=train, trace=tr, peak_bytes=2 ** 32)
    value = harness.metric_reader(name)(rec)
    assert value is not None and value == harness.metric_reader(FAMILIES[name])(rec)


def test_serving_readers():
    rec = {"config": harness.config("linknet34"), "traffic": harness.traffic("serve-5000-tta8"),
           "peaks": harness.peaks("NVIDIA H100 80GB HBM3"),
           "serve": {"images": 20, "window_s": 28.0, "tiles_per_image": 361,
                     "pass_ms": [25.0] * 920, "window_device_ms": 25000.0,
                     "window_views": 920 * 64},
           "trace": {"busy_s": 2.5, "window_s": 2.6, "device_events": 10, "views": 2 * 46 * 64,
                     "kernel_s": {"B1": 0.0, "B2": 0.07, "B3": 0.0}}}
    read = harness.metric_reader
    assert read("serve_s_per_image")(rec) == pytest.approx(1.4)
    assert read("serve_pass_ms")(rec) == pytest.approx(25.0)
    assert read("outside_pass_pct.serve")(rec) == pytest.approx(100 * (1 - 23.0 / 25.0))
    assert read("mfu_pct.serve")(rec) == pytest.approx(
        100 * 46.579861504e9 * 361 * 8 / 1.4 / 989e12)
    assert read("b2_roofline.serve")(rec) == pytest.approx(
        100 * 33947648 * 2 * 46 * 64 / 3.35e12 / 0.07)
    busy = 2.5 / (2 * 46 * 64) * 920 * 64
    assert read("device_idle_pct.serve")(rec) == pytest.approx(100 * (1 - busy / 25.0))
    assert read("train_images_per_s")(rec) is None
