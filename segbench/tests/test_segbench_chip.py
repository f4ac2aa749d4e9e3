"""On the card (marked ``chip``; each test skips without CUDA): every cell
runs through ``run.py`` with a short window and comes out correct with its
metrics, and each cell's fp8 control, at the cell's own size, comes out over
its limit.

    python -m pytest segbench/tests -q -m chip -p no:cacheprovider
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from segbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cuda, cell, trace):
    out = subprocess.run([sys.executable, "segbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 5), "--seconds", "6", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    wanted = {m["name"] for m in harness.cell_metrics(harness.benchmark(), cell, bool(trace))}
    assert set(result["metrics"]) == wanted
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_over_the_limit(cuda, cell):
    kind_name = harness.traffic(harness.workload(cell)["traffic"])["kind"]
    kind = harness.traffic_kind(kind_name)
    ctx = harness.Context(cell, 2 ** 31 + 9, 0.0, False, cuda)
    if kind_name == "train_steps":
        readings = calibrate.train_readings(kind, ctx, "control")
    else:
        readings = calibrate.serve_readings(kind, ctx, "control", kind.images(ctx))
    assert any(readings[k] > limit for k, limit in ctx.limits.items()), readings
