"""Served model FLOPs over the card's bf16 peak, in %: the configuration's
GFLOP per forward view times the views an image needs (its tiles, times 8
under D4 TTA; the padded tail of the last chunk not counted), over the
seconds per image."""


def read(rec):
    serve, counts, peaks = rec.get("serve"), rec["config"].get("counts"), rec.get("peaks")
    traffic = rec["traffic"]
    if not serve or not serve["images"] or not peaks or not counts \
            or counts["patch"] != traffic["patch"]:
        return None
    views = serve["tiles_per_image"] * (8 if traffic["tta"] else 1)
    flops = counts["serve_gflop_per_view"] * 1e9 * views
    return 100.0 * flops / (serve["window_s"] / serve["images"]) / peaks["bf16_flops"]
