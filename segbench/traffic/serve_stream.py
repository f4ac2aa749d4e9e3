"""Serving traffic: one client in a closed loop, as ``submit_cli`` serves a
directory of INRIA tiles: seeded uint8 images through one
``segtpu_torch.inference.predict_tiled_stream`` call.

Set-up draws the configuration's model with the benchmark's seeded weights
(``train.state.make_predict_step``, bf16 autocast as the configuration
states), a pool of ``pool`` seeded ``image_size``^2 x 3 uint8 images made on
the device and kept on the host, and serves one whole image through the
same stream to warm every shape. The window then hands the stream an item
list longer than any window, the pool cycled, and ends at the first mask
that comes back after ``--seconds``; the stream is left by closing it, and
its ``finally`` stops its producer thread. With ``--trace 1`` the window's
model passes are timed with CUDA events around the ``predict_fn`` the
stream is given, and a profiled stretch of ``trace_images`` images follows
in the same stream, the card drained before and after.

Once the window has closed and the program's state is freed, the plain
reference computes the probabilities of ``check_images`` pool images drawn
from the seed, and every distinct mask the window served for them is held
against the reference's mask.

Parameters (``traffic/<mix>.json``): ``image_size``, ``pool``, ``patch``,
``tile_batch``, ``tta``, ``depth``, ``check_images``, ``trace_images``,
``tiles_per_call`` (the reference's tiles per model call).
"""

from __future__ import annotations

import functools
import gc
import hashlib
import math
import random
import time

import numpy as np
import torch
from torch.profiler import record_function

from segbench import harness, trace as tracing
from segbench.reference import numerics, tiled

ITEMS = 100_000


def images(ctx):
    """The pool: HWC uint8 host arrays, drawn on the device from the seed."""
    s, n = ctx.traffic["image_size"], ctx.traffic["pool"]
    gen = torch.Generator(device=ctx.device).manual_seed(harness.derive(ctx.seed, "images"))
    pool = torch.randint(0, 256, (n, s, s, 3), dtype=torch.uint8, generator=gen,
                         device=ctx.device)
    return list(pool.cpu().numpy())


def _reference_model(ctx, state, precision: str = "fp32"):
    return numerics.build(harness.reference_class(ctx.config), ctx.device, state,
                          numerics.Numerics(precision)).eval()


def _template(ctx):
    with torch.device("meta"):
        return harness.reference_class(ctx.config)(numerics.Numerics()).state_dict()


def serving_state(ctx) -> dict:
    """The seeded weights that both sides serve, with the configuration's
    ``serve.centre`` bias (the head's last) shifted by the fp32 reference's
    mean logit over ``centre_tiles`` seeded tiles, so that the masks hold
    both classes whatever the seed draws: random weights put the logits of
    a whole image on one side of the threshold for many seeds, and a mask
    of one class compares nothing. The shift is worked out once per run."""
    state = harness.seeded_state(_template(ctx), ctx.seed, ctx.device)
    name = ctx.config["serve"].get("centre")
    if name is None:
        return state
    if "centre" not in ctx.cache:
        norm, p, dev = ctx.config["serve"]["normalize"], ctx.traffic["patch"], ctx.device
        gen = torch.Generator(device=dev).manual_seed(harness.derive(ctx.seed, "centre"))
        tiles = torch.randint(0, 256, (ctx.config["serve"]["centre_tiles"], 3, p, p),
                              generator=gen, device=dev).float()
        mean = torch.tensor(norm["mean"], device=dev).view(1, 3, 1, 1)
        std = torch.tensor(norm["std"], device=dev).view(1, 3, 1, 1)
        model = _reference_model(ctx, state)
        with torch.no_grad(), numerics.exact():
            ctx.cache["centre"] = model((tiles * norm["scale"] - mean) / std).mean()
        del model
    state[name] = state[name] - ctx.cache["centre"]
    return state


def build_program(ctx):
    """``(model, predict_fn, stream keyword arguments)`` of the port."""
    from segtpu_torch.augment import host as aug
    from segtpu_torch.models import get_model
    from segtpu_torch.train.state import make_predict_step

    serve, traf = ctx.config["serve"], ctx.traffic
    model = get_model(ctx.config["model"], patch_size=traf["patch"], device=ctx.device)
    model.load_state_dict(serving_state(ctx))
    predict_fn = make_predict_step(model, bf16=serve["bf16"])
    norm = serve["normalize"]
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(
        scale=norm["scale"], mean=norm["mean"], std=norm["std"]))])
    kw = dict(test_transform=transform, patch_size=traf["patch"], batch_size=traf["tile_batch"],
              tta=traf["tta"], weight=serve["weight"], threshold=serve["threshold"],
              depth=traf["depth"], device=ctx.device)
    return model, predict_fn, kw


class Passes:
    """``predict_fn`` wrapped: device marks around each call and the views
    it was given (``--trace 1`` only)."""

    def __init__(self, predict_fn, marks: harness.Marks):
        self.fn, self.marks, self.calls, self.views = predict_fn, marks, [], 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("segbench.pass"):
            start = self.marks()
            y = self.fn(x)
            self.calls.append((start, self.marks()))
            self.views += x.shape[0]
        return y


def reference_probs(ctx, pool, indices, precision: str = "fp32"):
    """``{pool index: (H, W) fp32 probabilities on the device}`` of the
    plain reference at ``precision``."""
    model = _reference_model(ctx, serving_state(ctx), precision)
    serve, traf = ctx.config["serve"], ctx.traffic

    def prob(x):
        return torch.sigmoid(model.nx.forward(model, x))

    out = {}
    with torch.no_grad(), numerics.exact():
        for i in indices:
            p = tiled.probabilities(prob, pool[i], serve["normalize"], traf["patch"], traf["tta"],
                                    traf["tiles_per_call"], ctx.device)
            out[i] = p
    return out


def mismatch(mask: np.ndarray, ref: torch.Tensor, threshold: float) -> float:
    """The share of pixels where the served uint8 mask (0 or 255) is not
    the reference's probabilities ``ref`` thresholded."""
    served = torch.from_numpy(mask).to(ref.device)
    if served.shape != ref.shape:
        return 1.0
    return float(((served == 255) != (ref > threshold)).float().mean())


def run(ctx) -> dict:
    from segtpu_torch.inference import predict_tiled_stream

    traf, dev = ctx.traffic, ctx.device
    pool = images(ctx)
    ctx.mark("inputs")
    model, predict_fn, kw = build_program(ctx)
    harness.sync(dev)
    ctx.mark("program")
    for _ in predict_tiled_stream([(0, functools.partial(pool.__getitem__, 0))], predict_fn, **kw):
        pass
    harness.sync(dev)

    marks = harness.Marks(dev)
    passes = Passes(predict_fn, marks) if ctx.trace else None
    items = [(k, functools.partial(pool.__getitem__, k % len(pool))) for k in range(ITEMS)]
    rng = random.Random(harness.derive(ctx.seed, "check"))
    checked = sorted(rng.sample(range(len(pool)), traf["check_images"]))
    served = []
    ctx.window_starts()
    w0, t0 = marks(), time.perf_counter()
    stream = predict_tiled_stream(items, passes or predict_fn, **kw)
    try:
        for key, mask in stream:
            served.append(key)
            if key % len(pool) in checked:
                served[-1] = (key, mask)
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        t1, w1 = time.perf_counter(), marks()
        record = {"serve": {"images": len(served), "window_s": t1 - t0,
                            "tiles_per_image": tiled.tiles_per_image(
                                traf["image_size"], traf["image_size"], traf["patch"])}}
        if ctx.trace:
            window_calls, window_views = list(passes.calls), passes.views
            counter = {}

            def stretch():
                passes.views = 0
                for _ in range(traf["trace_images"]):
                    with record_function("segbench.stream"):
                        next(stream)
                counter["views"] = passes.views

            record["trace"] = tracing.capture(stretch, dev)
            record["trace"].update(counter)
            record["serve"]["pass_ms"] = [marks.ms(a, b) for a, b in window_calls]
            record["serve"]["window_views"] = window_views
            record["serve"]["window_device_ms"] = marks.ms(w0, w1)
    finally:
        stream.close()
    harness.sync(dev)
    record["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model, predict_fn, passes, kw
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # every distinct mask served for a checked pool image, against the reference
    distinct = {}
    for entry in served:
        if isinstance(entry, tuple):
            key, mask = entry
            digest = hashlib.blake2b(mask.tobytes(), digest_size=16).digest()
            distinct.setdefault((key % len(pool), digest), [mask, 0])[1] += 1
    refs = reference_probs(ctx, pool, checked)
    limit, threshold = ctx.limits["mask_mismatch"], ctx.config["serve"]["threshold"]
    # no mask compared reads as the worst share
    worst, failed = (0.0 if distinct else math.inf), 0
    for (i, _), (mask, count) in distinct.items():
        share = mismatch(mask, refs[i], threshold)
        worst = max(worst, share)
        failed += count if share > limit else 0
    record["checks"] = {"mask_mismatch": harness.check(worst, limit)}
    record["attempted"], record["failed"] = len(served), failed
    return record
