"""The card's peak allocated memory over set-up and window, in GiB
(``torch.cuda.max_memory_allocated``, reset once CUDA is up)."""


def read(rec):
    peak = rec.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
