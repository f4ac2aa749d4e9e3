"""The general part of segbench: finding a cell's files by name, seeding,
timing marks, judging the checks and putting the result line together.

Nothing here knows a configuration, a traffic mix or a metric: those are
files under ``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# Top-level module names that no run may hold once its window has closed:
# JAX and the JAX package the port was made from, compared whole
# ("segtpu_torch" is not "segtpu").
FORBIDDEN = ("jax", "jaxlib", "flax", "segtpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_module(path: Path, tag: str):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"segbench_{tag}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_class(conf: dict):
    """The plain reference that a configuration names (``module:factory``)."""
    module, factory = conf["reference"].split(":")
    return getattr(importlib.import_module(module), factory)


def traffic_kind(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py", "traffic")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    return load_module(HERE / "metrics" / f"{name}.py", "metric").read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The entries of ``BENCHMARK.json`` that ``cell`` reports: its end-to-end
    metrics without ``--trace``, its per-layer metrics with it."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> List[str]:
    """The entries of ``sys.modules`` whose top-level name is one of
    :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of a run seeded ``seed``."""
    digest = hashlib.blake2b(f"{seed}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Time marks in the device's order: CUDA events on a card (no host
    wait), the host clock on the CPU, whose ops run in the caller's order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _leaf_scale(name: str, t: torch.Tensor):
    """(std, mean, fold) of a state_dict entry's draw: He-normal for conv
    weights (torch's fan-in: ``shape[1] * kh * kw``, for a transposed conv
    too), small normals for biases and running means, ``1 + 0.1 N`` for
    normalisation weights, ``1 + 0.1 |N|`` for running variances."""
    if name.endswith(".running_mean"):
        return 0.01, 0.0, False
    if name.endswith(".running_var"):
        return 0.1, 1.0, True
    if name.endswith(".weight"):
        if t.dim() >= 2:
            fan_in = math.prod(t.shape[1:])
            return math.sqrt(2.0 / fan_in), 0.0, False
        return 0.1, 1.0, False
    if name.endswith(".bias"):
        return 0.01, 0.0, False
    raise ValueError(f"no draw for state_dict entry {name!r} of shape {tuple(t.shape)}")


def seeded_state(template: Dict[str, torch.Tensor], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every entry of ``template`` (a state_dict: names and shapes) drawn
    from ``seed`` on ``device`` in fp32: one normal draw for all of them, in
    the order of the sorted names, cut and scaled per entry
    (:func:`_leaf_scale`); integer entries (BatchNorm's count) are zeros.
    The same names and shapes give the same tensors, whatever module holds
    them."""
    names = sorted(n for n, t in template.items() if t.is_floating_point())
    total = sum(template[n].numel() for n in names)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    state, offset = {}, 0
    for name in names:
        t = template[name]
        v = flat[offset:offset + t.numel()].view(t.shape)
        offset += t.numel()
        std, mean, fold = _leaf_scale(name, t)
        v.mul_(std)
        if fold:
            v.abs_()
        state[name] = v.add_(mean)
    for name, t in template.items():
        if not t.is_floating_point():
            state[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return state


# ---------------------------------------------------------------------------
# Checks and the result line
# ---------------------------------------------------------------------------

def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def passed(c: dict) -> bool:
    return math.isfinite(c["value"]) and c["value"] <= c["limit"]


def peaks(device_name: str) -> Optional[dict]:
    """The data-sheet peaks of the card called ``device_name``; None for a
    card (or the CPU) that the table does not hold."""
    return load_json(HERE / "peaks.json").get(device_name)


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


class Context:
    """What a traffic kind gets: the run's arguments, the cell's files and
    the clock that fixes the set-up time."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
                 origin: Optional[float] = None, overrides: Optional[dict] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        spec = workload(cell)
        overrides = overrides or {}
        self.config = dict(config(spec["config"]), **overrides.get("config", {}))
        self.traffic = dict(traffic(spec["traffic"]), **overrides.get("traffic", {}))
        self.limits = dict(spec["limits"], **overrides.get("limits", {}))
        self.peaks = peaks(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
        # the host clock at the run's start: set-up runs from there to the window
        self.origin = time.perf_counter() if origin is None else origin
        self.setup_s = None
        self.marks = [("start", self.origin)]
        # what a traffic kind works out once per run and hands to both sides
        self.cache: dict = {}

    def mark(self, name: str) -> None:
        """The end of a set-up phase called ``name`` (the result's ``setup_parts``)."""
        self.marks.append((name, time.perf_counter()))

    def window_starts(self) -> float:
        self.mark("warm")
        self.setup_s = time.perf_counter() - self.origin
        return self.setup_s

    def setup_parts(self) -> dict:
        return {name: t - before for (_, before), (name, t) in zip(self.marks, self.marks[1:])}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             origin: Optional[float] = None, overrides: Optional[dict] = None,
             kind_hook=None) -> dict:
    """One run of ``cell``: its traffic kind drives the program, the cell's
    metrics read the record, and the checks decide ``correct``. Returns the
    result line's object. ``overrides`` replace entries of the cell's
    configuration, traffic and limits (the tests' small sizes);
    ``kind_hook(module)`` may patch the traffic kind before it runs (the
    tests' faults)."""
    ctx = Context(cell, seed, seconds, trace, device, origin, overrides)
    kind = traffic_kind(ctx.traffic["kind"])
    if kind_hook is not None:
        kind_hook(kind)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx.mark("cuda")
    record = kind.run(ctx)
    record.update(config=ctx.config, traffic=ctx.traffic, peaks=ctx.peaks, setup_s=ctx.setup_s)

    metrics = {}
    for entry in cell_metrics(benchmark(), cell, trace):
        value = metric_reader(entry["name"])(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = record["checks"]
    correct = all(passed(c) for c in checks.values()) and record["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": record["peak_bytes"]}
    if device.type == "cuda":
        dev["card"] = card_line()
    result = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev}
    tr = record.get("trace")
    if trace and tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    result["setup_parts"] = ctx.setup_parts()
    result["checks"] = checks
    return result
