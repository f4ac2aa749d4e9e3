"""The share of the serving window's device time in which no model pass
runs, in %: the stream's own work (upload, tile gather, TTA, merge,
threshold, fetch) and the card's idle time (``--trace 1``, CUDA events)."""


def read(rec):
    serve = rec.get("serve") or {}
    passes, window = serve.get("pass_ms"), serve.get("window_device_ms")
    if not passes or not window:
        return None
    return 100.0 * (1.0 - sum(passes) / window)
