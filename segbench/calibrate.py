"""The readings that a cell's limits are set from, at the cell's own size on
the card, in one process:

* ``program``: the numbers that a run compares, for each of ``--seeds``
  seeds: the timed path's first steps, or the masks it serves for the
  checked images, against the fp32 reference;
* ``control``: the reference in fp8 put in the program's place, on
  ``--controls`` seeds;
* ``faults``: the program with a fault planted, on ``--faults`` seeds:
  training, half of the batch left out of the loss (the mean over the
  rest), a step that leaves the parameters unchanged, and for a
  configuration that freezes its encoder a step built without the freeze
  (``thawed``: the encoder trains); serving, half of
  each pass's views left out (their probabilities nought) and an answer
  altered where it is produced (a quarter of the mask inverted).

    python3 segbench/calibrate.py --workload <cell> [--seeds 12] [--controls 3] \
        [--faults 3] [--first-seed N] [--out file.json]

Prints one JSON object; the first seed is ``--first-seed`` and the others
follow it.
"""

from __future__ import annotations

import argparse
import copy
import functools
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from segbench import harness, shapes  # noqa: E402
from segbench.reference import train as ref_train  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def half_batch_loss(loss_fn):
    """A loss that leaves out half of the batch and takes the mean over the
    rest."""

    def loss(logits, y, **kw):
        half = max(1, logits.shape[0] // 2)
        return loss_fn(logits[:half], y[:half], **kw)

    return loss


def train_fault_program(kind, fault: str):
    """``kind.build_program`` with ``fault`` planted in the step it builds."""
    build = kind.build_program

    def faulty(ctx):
        if fault == "half_batch":
            import segtpu_torch.ops.losses as losses

            get_loss = losses.get_loss
            losses.get_loss = lambda name: half_batch_loss(get_loss(name))
            try:
                return build(ctx)
            finally:
                losses.get_loss = get_loss
        if fault == "thawed":
            thawed = copy.copy(ctx)
            thawed.config = dict(ctx.config, train=dict(ctx.config["train"], freeze_encoder=False))
            return build(thawed)
        step, model, opt = build(ctx)
        if fault == "unchanged":
            opt.step = lambda *a, **k: None
        return step, model, opt

    return faulty


def train_readings(kind, ctx, mode: str) -> dict:
    traf = ctx.traffic
    batches = shapes.pool(traf["pool"], traf["batch"], traf["patch"], ctx.seed,
                          ctx.device)[:traf["warm_steps"]]
    ref = kind.reference(ctx, batches)
    _free(ctx.device)
    if mode == "control":
        got = kind.reference(ctx, batches, "fp8")
    else:
        build = kind.build_program if mode == "program" else train_fault_program(kind, mode)
        step, model, opt = build(ctx)
        got = kind.warm_steps(ctx, step, model, opt, batches)
        del step, model, opt
    _free(ctx.device)
    out = kind.gaps(got, ref)
    out["step_loss_gaps"] = [abs(p - r) / abs(r) for p, r in zip(got["losses"], ref["losses"])]
    for key in ("grad", "change"):
        out[f"{key}_leaf"] = ref_train.leaf_gaps(got[key], ref[key], ref["grad"])[1]
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def half_views(predict_fn):
    """``predict_fn`` that leaves out the second half of each pass's views:
    their probabilities come back as nought."""

    def fn(x):
        half = predict_fn(x[: x.shape[0] // 2])
        return torch.cat([half, torch.zeros_like(half)])[: x.shape[0]]

    return fn


def serve_readings(kind, ctx, mode: str, pool) -> dict:
    import random

    from segtpu_torch.inference import predict_tiled_stream

    rng = random.Random(harness.derive(ctx.seed, "check"))
    checked = sorted(rng.sample(range(len(pool)), ctx.traffic["check_images"]))
    threshold = ctx.config["serve"]["threshold"]
    refs = kind.reference_probs(ctx, pool, checked)
    _free(ctx.device)
    if mode == "control":
        fp8 = kind.reference_probs(ctx, pool, checked, "fp8")
        masks = {i: ((fp8[i] > threshold).to(torch.uint8) * 255).cpu().numpy() for i in checked}
    else:
        model, predict_fn, kw = kind.build_program(ctx)
        if mode == "half_views":
            predict_fn = half_views(predict_fn)
        items = [(i, functools.partial(pool.__getitem__, i)) for i in checked]
        masks = dict(predict_tiled_stream(items, predict_fn, **kw))
        if mode == "altered":
            for mask in masks.values():
                h, w = mask.shape[0] // 2, mask.shape[1] // 2
                mask[:h, :w] = 255 - mask[:h, :w]
        del model, predict_fn
    _free(ctx.device)
    out = {"mask_mismatch": max(kind.mismatch(masks[i], refs[i], threshold) for i in checked)}
    out.update(diagnostics(masks, refs, checked, threshold))
    return out


def diagnostics(masks, refs, checked, threshold) -> dict:
    """Per checked image: the reference's positive share, the share of its
    pixels within ``d`` of the threshold, and the share of pixels served
    wrong whose reference lies more than ``d`` from it."""
    out = {"positive": [], "near": {}, "wrong_beyond": {}}
    for i in checked:
        ref = refs[i]
        wrong = (torch.from_numpy(masks[i]).to(ref.device) == 255) != (ref > threshold)
        gap = (ref - threshold).abs()
        out["positive"].append(float((ref > threshold).float().mean()))
        for d in (0.001, 0.003, 0.01, 0.03, 0.1):
            out["near"].setdefault(str(d), []).append(float((gap <= d).float().mean()))
            out["wrong_beyond"].setdefault(str(d), []).append(
                float((wrong & (gap > d)).float().mean()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    spec = harness.workload(args.workload)
    kind_name = harness.traffic(spec["traffic"])["kind"]
    kind = harness.traffic_kind(kind_name)
    if kind_name == "train_steps":
        frozen = ref_train.frozen_prefixes(harness.config(spec["config"]))
        fault_modes = ["half_batch", "unchanged"] + (["thawed"] if frozen else [])
    else:
        fault_modes = ["half_views", "altered"]
    plan = ([("program", i) for i in range(args.seeds)]
            + [("control", i) for i in range(args.controls)]
            + [(f, i) for f in fault_modes for i in range(args.faults)])
    out = {"workload": args.workload, "card": harness.card_line(), "readings": []}
    pools = {}
    for mode, i in plan:
        seed = args.first_seed + i
        ctx = harness.Context(args.workload, seed, 0.0, False, device)
        t0 = time.perf_counter()
        if kind_name == "train_steps":
            reading = train_readings(kind, ctx, mode)
        else:
            if seed not in pools:
                pools = {seed: kind.images(ctx)}
            reading = serve_readings(kind, ctx, mode, pools[seed])
        row = dict(mode=mode, seed=seed, seconds=time.perf_counter() - t0, **reading)
        out["readings"].append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
