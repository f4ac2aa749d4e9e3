"""The port's bench (segtpu_torch.bench) against segtpu's bench.py, on the CPU.

The six configs and their recipes are segtpu's; the ``--data-dir`` batch is
segtpu's ``_training_batch`` bit for bit (after NHWC -> NCHW) on a nuclei
fixture; ``--all`` prints six lines; ``vs_baseline`` is read from
``bench_baseline.json``, never written; the ad-hoc mode has segtpu's
defaults; config #5 and the CPU baseline run at tiny sizes. The measure
functions are stubbed where a test checks only the harness.
"""

import inspect
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402

from segtpu_torch import bench  # noqa: E402
from segtpu_torch.data.nuclei_fixture import write_fixture  # noqa: E402
from torch_port_util import module_tmp, tmp_path  # noqa: E402,F401  (removed after use)

PATCH = 64


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_dir(module_tmp):  # noqa: F811
    path = module_tmp("nuclei") / "dsb2018"
    write_fixture(str(path), 2, 20260819)
    return path


def test_configs_are_segtpus_six():
    assert set(bench.CONFIG_NAMES) == set(jax_bench.BENCH_CONFIGS) and len(bench.CONFIG_NAMES) == 6
    assert jax_bench.BENCH_CONFIGS[bench.TILED_CONFIG] == {"kind": "tiled"}
    defaults = {k: p.default for k, p in
                inspect.signature(jax_bench.measure_tiled_inference).parameters.items()}
    assert bench.TILED == defaults


@pytest.mark.parametrize("seed", [0, 7])
def test_data_dir_batch_equals_segtpus(fixture_dir, seed):
    """The first 4 train samples at patch 64, drawn from Python's global
    ``random`` as segtpu draws them."""
    random.seed(seed)
    want_x, want_y = jax_bench._training_batch(4, PATCH, str(fixture_dir))
    random.seed(seed)
    x, y = bench.dsb2018_batch(4, PATCH, str(fixture_dir))
    assert x.dtype == torch.float32 and x.shape == (4, 3, PATCH, PATCH)
    assert np.array_equal(x.numpy(), np.asarray(want_x).transpose(0, 3, 1, 2))
    assert np.array_equal(y.numpy(), np.asarray(want_y).transpose(0, 3, 1, 2))


def test_training_batch_falls_back_to_shapes(fixture_dir, tmp_path):  # noqa: F811
    dev = torch.device("cpu")
    x, y, source = bench.training_batch(2, PATCH, dev, data_dir=str(tmp_path / "absent"))
    assert source == "synthetic shapes" and x.shape == (2, 3, PATCH, PATCH)
    assert bench.training_batch(2, PATCH, dev, data_dir=str(fixture_dir))[2] == "dsb2018"


def test_measure_train_takes_the_dsb2018_batch(fixture_dir):
    info = {}
    ips = bench.measure_train(batch_size=2, patch=PATCH, steps=1, warmup=1, model_name="zf_unet",
                              loss_name="bce", optimizer="sgd", device="cpu", s2d=None,
                              data_dir=str(fixture_dir), info=info)
    assert np.isfinite(ips) and ips > 0 and info == {"form": "s2d", "source": "dsb2018"}


def _stub(monkeypatch, seen):
    def fake_train(**kwargs):
        seen.setdefault("train", []).append(kwargs)
        return 10.0

    def fake_tiled(**kwargs):
        seen.setdefault("tiled", []).append(kwargs)
        return 1.25

    monkeypatch.setattr(bench, "measure_train", fake_train)
    monkeypatch.setattr(bench, "measure_tiled_inference", fake_tiled)


def test_all_prints_six_lines(monkeypatch, capsys):
    seen = {}
    _stub(monkeypatch, seen)
    bench.main(["--all", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == 6 and len(seen["train"]) == 5 and len(seen["tiled"]) == 1
    metrics = [line["metric"] for line in lines]
    assert [m.split(" ")[0] for m in metrics] == bench.CONFIG_NAMES
    tiled = lines[bench.CONFIG_NAMES.index(bench.TILED_CONFIG)]
    assert tiled["metric"] == "inria-tiled-inference-5000 (linknet34@512, D4 TTA x8, pyramid merge)"
    assert tiled["value"] == 1.25 and tiled["unit"] == "sec/image/cpu"
    assert seen["tiled"][0] == dict(bench.TILED, device=torch.device("cpu"))
    assert all(line["device"] == "cpu" for line in lines)
    assert {line["form"] for line in lines} == {"s2d", "normal"}


def test_vs_baseline_is_read_from_bench_baseline_json(monkeypatch):
    seen = {}
    _stub(monkeypatch, seen)
    before = bench.BASELINE_PATH.read_bytes()
    cpu = json.loads(before)["cpu_images_per_sec"]
    line = bench.run_config("zf_unet-512", device="cpu")
    assert line["vs_baseline"] == round(10.0 / cpu, 2)
    assert bench.run_config("albunet-finetune-512", device="cpu")["vs_baseline"] is None
    assert bench.BASELINE_PATH.read_bytes() == before
    monkeypatch.setattr(bench, "BASELINE_PATH", bench.BASELINE_PATH.parent / "absent.json")
    assert bench.read_baseline(bench.BASELINE_PATH) is None


@pytest.mark.parametrize("flags,s2d", [([], None), (["--no-s2d"], False)])
def test_ad_hoc_mode_has_segtpus_defaults(flags, s2d, monkeypatch, capsys):
    seen = {}

    def fake_train(**kwargs):
        seen.update(kwargs)
        kwargs["info"].update(form="s2d" if s2d is None else "normal", source="synthetic shapes")
        return 12.0

    monkeypatch.setattr(bench, "measure_train", fake_train)
    bench.main(["--device", "cpu"] + flags)
    line = json.loads(capsys.readouterr().out)
    assert {k: seen[k] for k in ("model_name", "batch_size", "patch", "steps", "loss_name",
                                 "optimizer", "s2d")} == dict(
        model_name="zf_unet", batch_size=16, patch=512, steps=20, loss_name="bce",
        optimizer="sgd", s2d=s2d)
    assert line["metric"] == "zf_unet 512^2 bf16 train throughput (synthetic shapes)"
    cpu = json.loads(bench.BASELINE_PATH.read_text())["cpu_images_per_sec"]
    assert line["vs_baseline"] == round(12.0 / cpu, 2)


def test_tiled_inference_runs_on_the_cpu():
    secs = bench.measure_tiled_inference(patch=32, image_size=80, batch_size=16, n_images=2,
                                         repeats=1, device="cpu")
    assert np.isfinite(secs) and secs > 0
    images = bench.tiled_images(2, 80)
    want = np.random.RandomState(0)
    for image in images:
        assert np.array_equal(image, (want.rand(80, 80, 3) * 255).astype(np.uint8))


def test_cpu_baseline_runs_and_writes_nothing(capsys):
    before = bench.BASELINE_PATH.read_bytes()
    ips = bench.measure_cpu_baseline(batch_size=1, patch=32, steps=1)
    assert np.isfinite(ips) and ips > 0 and bench.BASELINE_PATH.read_bytes() == before
