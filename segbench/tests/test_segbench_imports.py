"""No run holds JAX or segtpu: the check that run.py makes after each run,
and the references' imports."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from segbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEGBENCH = ROOT / "segbench"


@pytest.mark.parametrize("modules, found", [
    (["segtpu_torch", "segtpu_torch.models.linknet", "numpy", "torch"], []),
    (["segtpu_torchvision", "segtpux", "jaxtyping"], []),
    (["segtpu"], ["segtpu"]),
    (["segtpu.models.linknet", "segtpu_torch"], ["segtpu.models.linknet"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_the_port_and_the_harness_alone_pass_the_check():
    """A process that imports segtpu_torch's serving and training paths and
    every file of segbench holds no module of JAX or segtpu."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import segtpu_torch, segtpu_torch.inference, segtpu_torch.train.state, segtpu_torch.models
import segtpu_torch.ops.losses, segtpu_torch.ops.metrics, segtpu_torch.train.optim
import segtpu_torch.augment.host
from segbench import harness, counts, shapes, trace
import segbench.calibrate
for kind in ("serve_stream", "train_steps"):
    harness.traffic_kind(kind)
bench = harness.benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.metric_reader(m["name"])
import segbench.reference.linknet34, segbench.reference.tiramisu, segbench.reference.tiled
import segbench.reference.zf_unet, segbench.reference.albunet
import segbench.reference.train
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((SEGBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {name.split(".", 1)[0] for name in _imported(path)}
    assert not tops & {"segtpu_torch", "segtpu", "jax", "jaxlib", "flax"}, tops


@pytest.mark.parametrize("path", sorted(SEGBENCH.rglob("*.py")), ids=lambda p: str(p.name))
def test_no_segbench_file_imports_jax_or_segtpu(path):
    tops = {name.split(".", 1)[0] for name in _imported(path)}
    assert not tops & {"segtpu", "jax", "jaxlib", "flax"}, tops
