"""Kernels B1 and B3, the training BatchNorms' reductions, against their
roofline, in %: the least time of their reads (3x the bytes of every
training-BatchNorm input of a step: the forward statistics read x, the
backward sums read x or z and the gradient) at the card's HBM rate, over
B1's and B3's device time per step in the profiled stretch."""


def read(rec):
    tr, counts, peaks = rec.get("trace"), rec["config"].get("counts"), rec.get("peaks")
    if "train" not in rec or not tr or not peaks or not counts \
            or counts["patch"] != rec["traffic"]["patch"] or not tr.get("steps"):
        return None
    kernel_s = tr["kernel_s"]["B1"] + tr["kernel_s"]["B3"]
    if kernel_s <= 0:
        return None
    nbytes = 3 * counts["bn_input_bytes_per_image"] * rec["traffic"]["batch"] * tr["steps"]
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / kernel_s
