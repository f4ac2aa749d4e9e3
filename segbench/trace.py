"""The profiled stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
steps or images, kept in memory, reduced to device time by kernel group, the
busy union, the idle gaps labelled with the benchmark's span open at the
time, and the device time of the port's kernels B1, B2 and B3.

The groups and the interval union follow ``segtpu_torch``'s profile_train
and profile_serve, copied here so that the program cannot change the
yardstick.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "segbench.stretch"
SPAN_PREFIX = "segbench."
# name fragments of the port's three hand-written kernels
KERNELS = {"B1": "SumsOp", "B2": "abn_norm_act", "B3": "AbnBwdOp"}
# kernel-name fragment -> group, first match wins
GROUPS = (
    ("SumsOp", "B1 channel sums"),
    ("AbnBwdOp", "B3 ABN backward sums"),
    ("abn_norm_act", "B2 affine+activation"),
    ("col2im", "tile merge (fold)"),
    ("wgrad", "convolution weight gradient"),
    ("dgrad", "convolution data gradient / transposed conv"),
    ("fprop", "convolution forward"),
    ("xmma", "convolution other"),
    ("conv", "convolution other"),
    ("gemm", "convolution other"),
    ("bn_fw_inf", "BatchNorm eval"),
    ("batch_norm", "BatchNorm eval"),
    ("nchwToNhwc", "layout transform"),
    ("nhwcToNchw", "layout transform"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("max_pool", "max pool"),
    ("CatArray", "concatenation"),
    ("bernoulli", "dropout masks"),
    ("reduce_kernel", "reductions"),
    ("Memcpy", "memory copies"),
    ("Memset", "memory sets"),
    ("elementwise", "elementwise"),
    ("copy", "copies"),
)
TOP = 10


def group_of(name: str) -> str:
    low = name.lower()
    for fragment, group in GROUPS:
        if fragment.lower() in low:
            return group
    return "other"


def merged(intervals) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _events(prof):
    """``(device intervals [(name, start ns, end ns)], benchmark spans
    [(name, start ns, end ns)])`` from the profiler's results; the device
    side of user annotations is left out, as it spans kernels."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        elif e.is_user_annotation() and e.name().startswith(SPAN_PREFIX):
            spans.append((e.name(), start, end))
    return device, spans


def reduce(device: List[Tuple[str, int, int]], spans: List[Tuple[str, int, int]]) -> dict:
    """The stretch's numbers from its device intervals and its spans (one of
    which is :data:`STRETCH`, the window): seconds busy (the union of device
    intervals inside the window) and of the window, device seconds by group
    and by kernel B1/B2/B3, and the ``breakdown`` of the result line."""
    window = next(((a, b) for n, a, b in spans if n == STRETCH), None)
    if window is None:
        raise ValueError("the trace holds no stretch span")
    w0, w1 = window
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    busy = merged((a, b) for _, a, b in inside)
    by_group: Dict[str, float] = defaultdict(float)
    by_kernel = {k: 0.0 for k in KERNELS}
    for name, a, b in inside:
        by_group[group_of(name)] += (b - a) / 1e9
        for k, fragment in KERNELS.items():
            if fragment.lower() in name.lower():
                by_kernel[k] += (b - a) / 1e9
    gaps, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    inner = [s for s in spans if s[0] != STRETCH]

    def label(a: int, b: int) -> str:
        mid = (a + b) // 2
        open_spans = [s for s in inner if s[1] <= mid < s[2]]
        # the innermost: the latest to open
        return max(open_spans, key=lambda s: s[1])[0] if open_spans else "outside any span"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    groups = sorted(by_group.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "device_events": len(inside),
        "kernel_s": by_kernel,
        "groups_s": dict(by_group),
        "breakdown": {"device_ops": [[g, s] for g, s in groups],
                      "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in longest]},
    }


def capture(stretch: Callable[[], None], device: torch.device, tries: int = 3) -> dict:
    """Run ``stretch()`` under ``torch.profiler`` inside the :data:`STRETCH`
    span, the device drained before and after, and reduce the trace. A
    profile with no device event on a card is taken again, ``tries`` times
    in all: a process's first profile once came back empty on an H100."""
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for _ in range(tries):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with profile(activities=activities) as prof:
            with record_function(STRETCH):
                stretch()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        device_events, spans = _events(prof)
        if device_events or device.type != "cuda":
            return reduce(device_events, spans)
    raise RuntimeError(f"{tries} profiles in a row hold no device event")
