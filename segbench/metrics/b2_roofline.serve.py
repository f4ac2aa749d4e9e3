"""Kernel B2 in serving against its roofline, in %: the decoder's
InPlaceABN inputs read once and outputs written once at bf16, per view,
times the views of the profiled stretch, at the card's HBM rate, over B2's
device time in the stretch."""


def read(rec):
    tr, counts, peaks = rec.get("trace"), rec["config"].get("counts"), rec.get("peaks")
    if "serve" not in rec or not tr or not peaks or not counts \
            or counts["patch"] != rec["traffic"]["patch"] or not tr.get("views"):
        return None
    if tr["kernel_s"]["B2"] <= 0:
        return None
    nbytes = counts["b2_bytes_per_view"] * tr["views"]
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / tr["kernel_s"]["B2"]
