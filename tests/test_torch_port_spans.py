"""segtpu_torch.spans: the recorder off and on, and the spans of the serving
stream and of the training step on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch

from segtpu_torch import inference, spans
from segtpu_torch.ops import losses, metrics
from segtpu_torch.train import optim
from segtpu_torch.train.state import make_train_step

STREAM = ["segtpu_torch.stream." + s
          for s in ("prepare", "wait", "upload", "sweep", "merge", "fetch")]
PHASES = ["segtpu_torch.step." + s
          for s in ("augment", "forward", "loss", "backward", "optimizer", "metrics")]


@pytest.fixture
def recorder():
    spans.enable()
    try:
        yield
    finally:
        spans.disable()


def _names(events):
    return {e.name for e in events}


def test_off_is_one_shared_no_op():
    a, b = spans.span("x", key=1), spans.span("y", device=True)
    assert a is b
    with a as opened:
        opened.key = 3
    assert opened.key is None
    assert spans.drain() == []


@pytest.mark.parametrize("on", [False, True])
def test_record_function_only_while_on(on):
    from torch.profiler import ProfilerActivity, profile

    if on:
        spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("segtpu_torch.test"):
                torch.ones(4).sum()
    finally:
        spans.disable()
    assert ("segtpu_torch.test" in {e.name for e in prof.events()}) == on


def test_nesting_keys_threads_and_drain(recorder):
    def worker():
        with spans.span("other", key="w"):
            pass

    with spans.span("outer", key=7) as outer:
        with spans.span("inner") as inner:
            inner.key = 8
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    got = spans.drain()
    by = {s.name: s for s in got}
    assert [s.name for s in got] == ["inner", "other", "outer"]
    assert by["inner"].parent is outer and by["outer"].parent is None
    # a span on another thread does not nest in this thread's open span
    assert by["other"].parent is None and by["other"].thread != by["outer"].thread
    assert (by["outer"].key, by["inner"].key, by["other"].key) == (7, 8, "w")
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns \
        <= by["outer"].end_ns
    assert all(s.ms >= 0 for s in got)
    assert spans.drain() == []
    with spans.span("later"):
        pass
    assert [s.name for s in spans.drain()] == ["later"]


def test_disable_drops_what_is_left(recorder):
    with spans.span("kept"):
        pass
    spans.disable()
    assert spans.drain() == []
    spans.enable()
    assert spans.drain() == []


def test_lead_ms_is_none_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spans.enable()
    try:
        with spans.span("segtpu_torch.step", 0, device=True):
            pass
        (s,) = spans.drain()
    finally:
        spans.disable()
    assert s.lead_ms is None and s.device_ns is None


def _step(augment):
    torch.manual_seed(0)
    model = torch.nn.Conv2d(3, 1, 3, padding=1)
    identity = (lambda g, x, y: (x, y)) if augment else None
    return make_train_step(model, optim.get_optimizer("adam", model.parameters(), 1e-3),
                           losses.get_loss("bce"), metrics.default_metrics(),
                           augment_fn=identity)


@pytest.mark.parametrize("augment", [False, True])
def test_train_step_spans(recorder, augment):
    step = _step(augment)
    x = torch.rand(2, 3, 16, 16)
    y = (torch.rand(2, 1, 16, 16) > 0.5).float()
    for _ in range(2):
        step(x, y, 1e-3)
    got = spans.drain()
    steps = [s for s in got if s.name == "segtpu_torch.step"]
    assert [s.key for s in steps] == [0, 1]
    phases = PHASES if augment else PHASES[1:]
    for outer in steps:
        inside = sorted((s for s in got if s.parent is outer), key=lambda s: s.start_ns)
        assert [s.name for s in inside] == phases
        assert all(s.key == outer.key for s in inside)
        assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in inside)
    assert len(got) == 2 * (1 + len(phases))


def test_train_step_records_nothing_while_off():
    step = _step(False)
    step(torch.rand(2, 3, 16, 16), torch.zeros(2, 1, 16, 16), 1e-3)
    assert spans.drain() == []


@pytest.mark.parametrize("depth", [0, 2])
def test_stream_spans(recorder, depth):
    rng = np.random.default_rng(0)
    images = {k: rng.integers(0, 256, (48, 40, 3), dtype=np.uint8) for k in "abcd"}
    items = [(k, (lambda k=k: images[k])) for k in images]

    def predict_fn(x):
        return torch.sigmoid(x.mean(1, keepdim=True))

    t0 = time.perf_counter_ns()
    out = list(inference.predict_tiled_stream(items, predict_fn, patch_size=16, batch_size=4,
                                              tta=False, threshold=0.5, depth=depth,
                                              device="cpu"))
    wall = time.perf_counter_ns() - t0
    assert [k for k, _ in out] == list(images)
    got = spans.drain()
    for name in STREAM:
        assert sorted(s.key for s in got if s.name == name) == sorted(images), name
    assert _names(got) == set(STREAM)
    producer = {s.thread for s in got if s.name == "segtpu_torch.stream.prepare"}
    consumer = [s for s in got if s.name != "segtpu_torch.stream.prepare"]
    assert len({s.thread for s in consumer}) == 1 and not producer & {consumer[0].thread}
    assert all(s.parent is None for s in got)
    assert sum(s.end_ns - s.start_ns for s in consumer) <= wall


def test_predict_tiled_shares_the_dispatch_spans(recorder):
    image = np.zeros((32, 32, 3), np.uint8)
    inference.predict_tiled(image, lambda x: torch.sigmoid(x[:, :1]), patch_size=16,
                            batch_size=4, tta=False, device="cpu")
    got = spans.drain()
    assert [s.name for s in got] == STREAM[2:5] and all(s.key is None for s in got)
