"""The training window's model FLOPs over the card's bf16 peak, in %: the
configuration's model GFLOP per image (convolutions' forward, data and
weight gradients, counted from the plain reference at the counted patch)
times the images stepped, over the window's device seconds."""


def read(rec):
    train, counts, peaks = rec.get("train"), rec["config"].get("counts"), rec.get("peaks")
    if not train or not peaks or not counts or counts["patch"] != rec["traffic"]["patch"]:
        return None
    flops = counts["train_gflop_per_image"] * 1e9 * train["images"]
    return 100.0 * flops / (train["window_ms"] / 1e3) / peaks["bf16_flops"]
