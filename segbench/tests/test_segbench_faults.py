"""The check that decides ``correct``, driven through the rest of a run on the
CPU at small sizes (no look for a card): sound runs pass the cells' limits,
and the timed path broken underneath comes out not correct. The fp8
control, whose readings the limits were set against at the cells' own
sizes, is ``test_segbench_chip.py``'s."""

import functools

import pytest
import torch

from segbench import calibrate, harness

CPU = torch.device("cpu")
TRAIN = ["tiramisu67.train-512-b4", "linknet34.train-512-b16"]
SERVE = ["linknet34.serve-5000-tta8", "linknet34.serve-5000-notta"]
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _overrides(cell: str) -> dict:
    conf = harness.config(harness.workload(cell)["config"])
    if "train" in cell:
        return {"config": {"train": dict(conf["train"], bf16=False)},
                "traffic": {"batch": 2, "patch": 64, "pool": 4, "trace_steps": 1}}
    return {"config": {"serve": dict(conf["serve"], bf16=False)},
            "traffic": {"image_size": 150, "patch": 64, "tile_batch": 16, "pool": 2,
                        "check_images": 2, "trace_images": 1, "tiles_per_call": 4}}


def _run(cell: str, hook=None, trace: bool = False) -> dict:
    return harness.run_cell(cell, SEED, 0.5, trace, CPU, overrides=_overrides(cell),
                            kind_hook=hook)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    result = _run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    if trace:
        assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(cell, fault):
    def hook(kind):
        kind.build_program = calibrate.train_fault_program(kind, fault)

    result = _run(cell, hook)
    assert not result["correct"], result["checks"]


def _altered_stream(stream):
    @functools.wraps(stream)
    def altered(*args, **kwargs):
        for key, mask in stream(*args, **kwargs):
            mask = mask.copy()
            mask[:64, :64] = 255 - mask[:64, :64]
            yield key, mask

    return altered


@pytest.mark.parametrize("cell", SERVE)
def test_serving_answer_altered_is_not_correct(cell, monkeypatch):
    import segtpu_torch.inference as inference

    monkeypatch.setattr(inference, "predict_tiled_stream",
                        _altered_stream(inference.predict_tiled_stream))
    result = _run(cell)
    assert not result["correct"] and result["failed"] > 0, result["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_serving_half_the_views_is_not_correct(cell):
    def hook(kind):
        build = kind.build_program

        def faulty(ctx):
            model, predict_fn, kw = build(ctx)
            return model, calibrate.half_views(predict_fn), kw

        kind.build_program = faulty

    result = _run(cell, hook)
    assert not result["correct"], result["checks"]
