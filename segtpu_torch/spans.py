"""Spans: named stretches of host time at segtpu_torch's layer boundaries,
kept in memory for a caller that asks for them.

    from segtpu_torch import spans

    spans.enable()
    ...                     # the program runs; its spans are recorded
    for s in spans.drain():
        print(s.name, s.key, s.thread, s.start_ns, s.end_ns, s.lead_ms)
    spans.disable()

The recorder is off by default. While it is off, :func:`span` returns one
shared no-op context: it reads no clock, records no CUDA event and opens no
``record_function``. Nothing in the package depends on it being on.

Each span records its name, a ``key`` (the image's item key in the serving
stream, the step's index in training, so that one request's spans share
it), its parent (the span open on the same thread when it opened), its
thread (the OS thread id, as a profiler's trace names it) and its start and
end on ``time.perf_counter_ns()``.

Device time on the host clock: :func:`enable` on a machine with CUDA drains
the device, records an anchor event and reads the host clock at once, so
the anchor runs within about 0.1 ms of that reading. A span opened with
``device=True`` records a CUDA event on the current stream as it opens;
:func:`drain` waits for the device once and puts each event on the host
clock as the anchor's host time plus ``anchor.elapsed_time(event)``. The
span's ``lead_ms`` is that time less its host start: how long its first
work waited in the device's queue, about 0 (to the anchor's 0.1 ms) when
the card was idle waiting for the host. Without CUDA, or without
``device=True``, it is None.

While ``torch.profiler`` is recording, each span also opens a
``record_function`` of its name, so that it lies on the profiler's timeline
beside the device's kernels.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch


class _Off:
    """The span while the recorder is off: a context that does nothing and
    takes a ``key`` set after it opened."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    key = property(lambda self: None, lambda self, value: None)


_OFF = _Off()


class _Recorder:
    """The spans of one :func:`enable`: the closed ones, each thread's stack
    of open ones, and the device anchor."""

    def __init__(self):
        self.lock = threading.Lock()
        self.closed: List[Span] = []
        self.local = threading.local()
        self.anchor = None
        self.anchor_ns = 0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
            self.anchor_ns = time.perf_counter_ns()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_recorder: Optional[_Recorder] = None


class Span:
    """One recorded span (module docstring). ``parent`` is the enclosing
    span on the same thread, or None; ``device_ns`` the host-clock time at
    which the device reached the span's event (``device=True`` on CUDA,
    after :func:`drain`), else None."""

    __slots__ = ("name", "key", "parent", "thread", "start_ns", "end_ns", "device_ns",
                 "_rec", "_event", "_annotation")

    def __init__(self, rec: _Recorder, name: str, key, device: bool):
        self._rec, self.name, self.key = rec, name, key
        timed = device and rec.anchor is not None
        self._event = torch.cuda.Event(enable_timing=True) if timed else None
        self.device_ns = None

    def __enter__(self):
        stack = self._rec.stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        self.end_ns = None
        self.start_ns = time.perf_counter_ns()
        if self._event is not None:
            self._event.record()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._rec.stack().pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        with self._rec.lock:
            self._rec.closed.append(self)
        return False

    @property
    def ms(self) -> float:
        """The span's host duration in milliseconds."""
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def lead_ms(self) -> Optional[float]:
        if self.device_ns is None:
            return None
        return (self.device_ns - self.start_ns) / 1e6


def span(name: str, key=None, device: bool = False):
    """A context that records the span ``name`` while the recorder is on
    (module docstring), the shared no-op while it is off. ``key`` may also
    be set on the returned object inside the block, once known."""
    rec = _recorder
    if rec is None:
        return _OFF
    return Span(rec, name, key, device)


def enable() -> None:
    """Start recording, on a fresh list and, with CUDA, a fresh anchor."""
    global _recorder
    _recorder = _Recorder()


def disable() -> None:
    """Stop recording; spans not drained are dropped, and spans still open
    close into nothing."""
    global _recorder
    _recorder = None


def drain() -> List[Span]:
    """The spans closed since :func:`enable` or the last drain, in the order
    they closed, with their device times on the host clock; the list is
    cleared. Empty while the recorder is off."""
    rec = _recorder
    if rec is None:
        return []
    with rec.lock:
        out, rec.closed = rec.closed, []
    timed = [s for s in out if s._event is not None]
    if timed:
        torch.cuda.synchronize()
        for s in timed:
            s.device_ns = rec.anchor_ns + round(rec.anchor.elapsed_time(s._event) * 1e6)
            s._event = None
    return out
