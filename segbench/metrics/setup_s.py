"""Set-up seconds: from ``run.py``'s first line to the first timed step or
image (imports, CUDA, the kernels' build or load, weights, inputs,
warm-up)."""


def read(rec):
    return rec.get("setup_s")
