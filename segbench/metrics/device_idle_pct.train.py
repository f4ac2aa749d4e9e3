"""The share of a training step in which no operation runs on the card, in
%: 100 minus the device's busy time per step (the union of the device
intervals of the profiled stretch, over its steps) over the mean step time
of the unprofiled window (CUDA events). The profiler's own host cost
stretches a host-bound step, so the stretch's wall time is not the
denominator."""


def read(rec):
    tr, train = rec.get("trace"), rec.get("train")
    if not train or not tr or not tr["device_events"] or not tr.get("steps"):
        return None
    step_s = train["window_ms"] / 1e3 / train["steps"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / step_s)
