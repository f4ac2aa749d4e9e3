"""Training traffic: segtpu_torch's training step driven back to back over a
pool of SHAPES batches made on the device from the seed.

Set-up builds the step (``train.state.make_train_step`` over the registry's
model with the benchmark's seeded weights, the configuration's loss,
optimizer, learning rate and bf16 autocast, the step's default metrics on)
and drives its first ``warm_steps`` steps on the pool's first batches: they
warm every shape, and their losses, the first gradient as the optimizer
holds it and the parameters' change are what the reference checks. The same
step then runs the window: batch ``k % pool`` at step ``k``, a CUDA event
at each step boundary, no wait for the card until the window has closed.
With ``--trace 1`` a profiled stretch of ``trace_steps`` steps follows.

Once the window has closed and the program's state is freed, the plain
reference (``configs/<config>.json``'s ``reference``) follows the first
steps from the same weights and batches in fp32.

A configuration whose recipe sets ``freeze_encoder`` trains with its
encoder frozen: the program's step gets the port's own mask
(``models.without_encoder``, the path of the bench's and the train CLI's
``--freeze-encoder``), the reference freezes the parameters under the
configuration's ``architecture.encoder_prefixes``, and the check adds
``frozen_change``.

Parameters (``traffic/<mix>.json``): ``batch``, ``patch``, ``pool``,
``warm_steps``, ``trace_steps``, and optionally ``form``: ``"normal"`` (the
default) or ``"s2d"``, the model's space-to-depth form (``model.s2d =
True``, as the CLIs' ``--s2d`` sets it). The reference has no form: s2d is
the same math, checked against the one normal-space reference.
"""

from __future__ import annotations

import gc
import math
import time

import torch
from torch.profiler import record_function

from segbench import harness, shapes, trace as tracing
from segbench.reference import numerics, train as ref_train


def build_program(ctx):
    """``(step, model, optimizer)`` of the port in the traffic's ``form``,
    with the seeded weights, its encoder frozen where the recipe says so."""
    from segtpu_torch.models import get_model, without_encoder
    from segtpu_torch.ops.losses import get_loss
    from segtpu_torch.ops.metrics import default_metrics
    from segtpu_torch.train.optim import get_optimizer
    from segtpu_torch.train.state import make_train_step

    recipe = ctx.config["train"]
    model = get_model(ctx.config["model"], patch_size=ctx.traffic["patch"], device=ctx.device)
    form = ctx.traffic.get("form", "normal")
    if form == "s2d":
        if not hasattr(model, "s2d"):
            raise ValueError(f"model {ctx.config['model']!r} has no s2d form")
        model.s2d = True
    elif form != "normal":
        raise ValueError(f"unknown form {form!r}: 'normal' or 's2d'")
    model.load_state_dict(harness.seeded_state(model.state_dict(), ctx.seed, ctx.device))
    opt = get_optimizer(recipe["optimizer"], model.parameters(), recipe["lr"])
    trainable = (without_encoder(ctx.config["model"], (n for n, _ in model.named_parameters()))
                 if recipe.get("freeze_encoder") else None)
    step = make_train_step(model, opt, get_loss(recipe["loss"]), default_metrics(),
                           bf16=recipe["bf16"], seed=ctx.seed, trainable_mask=trainable)
    return step, model, opt


def first_gradient(opt, model) -> dict:
    """Each parameter's first gradient as the optimizer got it, after one
    step: Adam's first moment over ``1 - beta1``; SGD, which keeps no state
    (and whose parameter change holds the gradient only to the parameter's
    rounding), the ``.grad`` it read. Tensors by name."""
    out = {}
    for name, p in model.named_parameters():
        if isinstance(opt, torch.optim.Adam):
            # no state: the optimizer never stepped, and got no gradient
            m = opt.state[p].get("exp_avg", torch.zeros_like(p))
            out[name] = m / (1 - opt.param_groups[0]["betas"][0])
        elif isinstance(opt, torch.optim.SGD):
            out[name] = p.grad
        else:
            raise ValueError(f"no first gradient for {type(opt).__name__}")
    return out


def warm_steps(ctx, step, model, opt, batches) -> dict:
    """The first steps: their losses, the logits of the first step's own
    forward (a hook on the model, removed after it), the first gradient's
    norms, the change's norms and the parameters' norms before the steps."""
    lr = ctx.config["train"]["lr"]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    hook = model.register_forward_hook(
        lambda m, i, out: seen.append(out.detach().to(torch.promote_types(out.dtype, torch.float32))))
    losses, grad = [], None
    for x, y in batches:
        losses.append(float(step(x, y, lr)["loss"]))
        if grad is None:
            hook.remove()
            grad = {n: float(g.norm()) for n, g in first_gradient(opt, model).items()}
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    norm = {n: float(p.norm()) for n, p in start.items()}
    return {"losses": losses, "logits": seen[0], "grad": grad, "change": change, "norm": norm}


def reference(ctx, batches, precision: str = "fp32") -> dict:
    """The plain reference's first steps on ``batches`` from the seeded
    weights, in ``precision``."""
    mask = torch.bfloat16 if ctx.config["train"]["bf16"] else torch.float32
    nx = numerics.Numerics(precision, mask_dtype=mask)
    cls = harness.reference_class(ctx.config)
    with torch.device("meta"):
        template = cls(nx).state_dict()
    state = harness.seeded_state(template, ctx.seed, ctx.device)
    model = numerics.build(cls, ctx.device, state, nx)
    with numerics.exact():
        return ref_train.run_steps(model, batches, ctx.config["train"], ctx.seed, nx,
                                   ref_train.frozen_prefixes(ctx.config))


def gaps(program: dict, ref: dict) -> dict:
    """Every number the check can compare: the worst step's relative loss
    gap; the first step's logits against the reference's (the norm of their
    difference over the reference's norm); the first gradient's and the
    change's gaps of norms by the worst leaf and by the median leaf of those
    that train (``reference.train.leaf_gaps``); and where the reference froze
    parameters, ``frozen_change``: the largest ``|change| / |parameter|``
    of the program's over them, which is nought where nothing moved."""
    out = {"loss_gap": max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                           for p, r in zip(program["losses"], ref["losses"]))}
    logit_gap = float((program["logits"] - ref["logits"]).norm() / ref["logits"].norm())
    out["logit_gap"] = logit_gap if math.isfinite(logit_gap) else math.inf
    for key in ("grad", "change"):
        worst, _, median = ref_train.leaf_gaps(program[key], ref[key], ref["grad"])
        out[f"{key}_gap"], out[f"{key}_median_gap"] = worst, median
    if ref.get("frozen"):
        moved = [program["change"][n] / program["norm"][n] if program["change"][n] else 0.0
                 for n in ref["frozen"]]
        out["frozen_change"] = max(m if math.isfinite(m) else math.inf for m in moved)
    return out


def compare(program: dict, ref: dict, limits: dict) -> dict:
    """The numbers that the cell's limits name, each beside its limit."""
    values = gaps(program, ref)
    return {k: harness.check(values[k], limit) for k, limit in limits.items()}


def run(ctx) -> dict:
    traf, dev = ctx.traffic, ctx.device
    lr = ctx.config["train"]["lr"]
    pool = shapes.pool(traf["pool"], traf["batch"], traf["patch"], ctx.seed, dev)
    harness.sync(dev)
    ctx.mark("inputs")
    step, model, opt = build_program(ctx)
    harness.sync(dev)
    ctx.mark("program")
    warm = warm_steps(ctx, step, model, opt, pool[:traf["warm_steps"]])
    harness.sync(dev)

    marks = harness.Marks(dev)
    k, losses = traf["warm_steps"], []
    ctx.window_starts()
    events = [marks()]
    t0 = time.perf_counter()
    while True:
        x, y = pool[k % len(pool)]
        losses.append(step(x, y, lr)["loss"])
        events.append(marks())
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    harness.sync(dev)
    step_ms = [marks.ms(a, b) for a, b in zip(events, events[1:])]
    record = {"train": {"steps": len(step_ms), "images": len(step_ms) * traf["batch"],
                        "window_ms": marks.ms(events[0], events[-1]), "step_ms": step_ms,
                        "batch": traf["batch"]}}
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    if ctx.trace:
        counter = {}

        def stretch():
            nonlocal k
            counter["steps"] = 0
            for _ in range(traf["trace_steps"]):
                x, y = pool[k % len(pool)]
                with record_function("segbench.step"):
                    step(x, y, lr)
                k += 1
                counter["steps"] += 1

        record["trace"] = tracing.capture(stretch, dev)
        record["trace"].update(counter)

    record["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del step, model, opt, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = pool[:traf["warm_steps"]]
    del pool
    ref = reference(ctx, batches)
    record["checks"] = compare(warm, ref, ctx.limits)
    record["attempted"], record["failed"] = len(step_ms), failed
    return record
