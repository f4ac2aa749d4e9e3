"""Device milliseconds per model pass: the mean over the window's
``predict_fn`` calls of the time between CUDA events recorded around each
(``--trace 1``)."""


def read(rec):
    passes = (rec.get("serve") or {}).get("pass_ms")
    return sum(passes) / len(passes) if passes else None
