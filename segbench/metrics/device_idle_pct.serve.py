"""The share of the serving window in which no operation runs on the card,
in %: 100 minus the device's busy time per view (the union of the device
intervals of the profiled stretch, over its views) times the window's views,
over the window's device time (CUDA events). The profiler's own host cost
stretches the host's share, so the stretch's wall time is not the
denominator."""


def read(rec):
    tr, serve = rec.get("trace"), rec.get("serve") or {}
    window_ms, views = serve.get("window_device_ms"), serve.get("window_views")
    if not tr or not tr["device_events"] or not tr.get("views") or not window_ms or not views:
        return None
    busy_s = tr["busy_s"] / tr["views"] * views
    return 100.0 * (1.0 - busy_s / (window_ms / 1e3))
