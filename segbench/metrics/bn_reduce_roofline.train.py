"""Kernels B1 and B3, the training BatchNorms' reductions, against their
roofline, in %: the least time of the reads that a step needs at the card's
HBM rate, over B1's and B3's device time per step in the profiled stretch.
The reads: the configuration's ``bn_reduce_bytes_per_image`` where it has
it (a frozen encoder's BatchNorms need only their forward statistics),
else 3x the bytes of every training-BatchNorm input (the forward statistics
read x, the backward sums read x or z and the gradient)."""


def read(rec):
    tr, counts, peaks = rec.get("trace"), rec["config"].get("counts"), rec.get("peaks")
    if "train" not in rec or not tr or not peaks or not counts \
            or counts["patch"] != rec["traffic"]["patch"] or not tr.get("steps"):
        return None
    kernel_s = tr["kernel_s"]["B1"] + tr["kernel_s"]["B3"]
    if kernel_s <= 0:
        return None
    per_image = counts.get("bn_reduce_bytes_per_image", 3 * counts["bn_input_bytes_per_image"])
    nbytes = per_image * rec["traffic"]["batch"] * tr["steps"]
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / kernel_s
