"""The 95th percentile of the window's step times, each the device time
between the CUDA events at its boundaries (``statistics.quantiles``,
exclusive method)."""

import statistics


def read(rec):
    train = rec.get("train")
    if not train or len(train["step_ms"]) < 20:
        return None
    return statistics.quantiles(train["step_ms"], n=20)[18]
