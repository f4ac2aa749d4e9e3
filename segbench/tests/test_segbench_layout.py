"""BENCHMARK.json against the benchmark's contract, and every configuration,
cell, traffic mix and metric found by its name."""

import json
import re

import pytest

from segbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
EXACT = {"frozen_change"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_limits():
    assert set(BENCH) == TOP
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert BENCH["command"][1].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metrics_rules():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            # the cell reports the end-to-end metric this one moves
            assert cell in E2E[m["moves"]].get("workloads", CELLS), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.workload(cell)
    assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert entry["chips"] == 1
    conf = harness.config(entry["config"])
    assert conf["name"] == entry["config"]
    traffic = harness.traffic(entry["traffic"])
    kind = harness.traffic_kind(traffic["kind"])
    assert callable(kind.run)
    # an exact comparison (nothing frozen moves at all) has the limit 0
    limits = spec["limits"]
    assert set(limits) and all(v > 0 or (k in EXACT and v == 0) for k, v in limits.items())
    e2e = harness.cell_metrics(BENCH, cell, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, trace=True)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"] == f"segbench/configs/{conf['name']}.json"
    data = harness.config(conf["name"])
    assert data["reduced"] == conf["reduced"] and data["source"] == conf["source"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = harness.metric_reader(metric)
    # a record with nothing to read gives nothing, never 0
    empty = {"config": {}, "traffic": {}, "peaks": None}
    assert read(empty) is None


def test_cell_metrics_selection():
    serve = "linknet34.serve-5000-tta8"
    assert {m["name"] for m in harness.cell_metrics(BENCH, serve, False)} == \
        {"serve_s_per_image", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(BENCH, "linknet34.serve-5000-notta", True)} \
        == {"outside_pass_pct.notta", "device_idle_pct.notta"}
    # the device-bound step reads the tight family, the host-paced steps theirs
    for cell in ("zf_unet.train-512-b16", "albunet_finetune.train-512-b64"):
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, False)} == \
            {"train_images_per_s", "train_step_p95_ms", "peak_mem_gib", "setup_s"}
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, True)} == \
            {"mfu_pct.train", "bn_reduce_roofline.train", "device_idle_pct.train"}
    for cell in ("tiramisu67.train-512-b4", "zf_unet.train-512-b16-s2d"):
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, False)} == \
            {"train_images_per_s.hostbound", "train_step_p95_ms.hostbound", "peak_mem_gib",
             "setup_s"}
        assert {m["name"] for m in harness.cell_metrics(BENCH, cell, True)} == \
            {"mfu_pct.hostbound", "bn_reduce_roofline.hostbound", "device_idle_pct.hostbound"}
    # the launch-bound step's images/s swings with the host's pace beyond any
    # bound, so it is read per layer, beside the p95 that it moves
    launch = "linknet34.train-512-b16"
    assert {m["name"] for m in harness.cell_metrics(BENCH, launch, False)} == \
        {"train_step_p95_ms.hostbound", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(BENCH, launch, True)} == \
        {"train_images_per_s.launchbound", "mfu_pct.launchbound",
         "bn_reduce_roofline.launchbound", "device_idle_pct.launchbound"}
