"""Time and accuracy of the reduction kernels B1 and B3 at the shapes of one
LinkNet34 training step, on one GPU.

    python -m segtpu_torch.profile_reduce [--out profile_reduce.json]

Time: at the step's largest normalisation input, 16x64x256^2 bf16
channels_last, the device milliseconds of B1 (single and pair form) and B3
(leaky_relu), medians of 20 runs by :func:`cuda_ms`, warm and cold in L2.

Accuracy: at each distinct BatchNorm and InPlaceABN input shape of the step
(bf16 channels_last, seeded inputs), each kernel's sums against float64 sums
of the same inputs, as the largest |error| over the sum of the terms'
magnitudes, per channel; the plain fp32 version on the card beside it.

Only the kernel wrappers and the plain versions of the package are used, so
this file, copied into another checkout of the package, measures that
checkout's kernels in the same way. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from segtpu_torch.device import card_line, resolve_device

SEED, BATCH, PATCH, SLOPE = 0, 16, 512, 0.01
# Device clock cycles of the spin kernel ahead of each timed run (about
# 0.5 ms at the H100's clock): longer than the host takes to launch a call.
SPIN_CYCLES = 1_000_000
# Zeroed between timed runs that are to find their inputs cold in L2: twice
# the H100's 50 MB L2.
L2_FLUSH_BYTES = 128 * 2**20


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs, each timed
    with its own pair of CUDA events. Before each run a spin kernel of
    SPIN_CYCLES keeps the device busy while the host enqueues the start
    event and ``fn``'s launches, so the events time the device's work and
    not the host's. ``flush``: a tensor zeroed before each timed run, outside
    the events, so that the run finds its inputs cold in L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# BatchNorm and InPlaceABN layers of each model of the registry
NORM_LAYERS = {"linknet34": (36, 12), "unet": (18, 0), "unet_abn": (0, 18), "zf_unet": (22, 0),
               "unet11": (0, 0), "unet16": (0, 0), "albunet": (36, 0), "tiramisu57": (49, 0),
               "tiramisu67": (60, 0), "tiramisu103": (96, 0), "dilated_linknet34": (48, 0),
               "gcn": (155, 0), "gcn34": (36, 0), "psp_net": (109, 0), "duc": (156, 0),
               "duc_dc": (156, 0), "linknext": (45, 0), "squeezenet": (0, 0)}


def step_norm_shapes(batch: int = BATCH, patch: int = PATCH, device="cuda",
                     model_name: str = "linknet34", **attrs):
    """Input shapes of the BatchNorm and InPlaceABN layers of one training
    step of ``model_name`` (LinkNet34: 36 and 12), in layer order, recorded
    by hooks on one forward pass: ``{"bn": [...], "abn": [...]}``. ``attrs``
    are set on the model first (``s2d=True``: the s2d form's inputs, 4C
    channels at half resolution on its s2d level)."""
    from segtpu_torch.models import get_model
    from segtpu_torch.models.layers import BatchNormTorch, InPlaceABN

    model = get_model(model_name, patch_size=patch, device=device, seed=SEED)
    for key, value in attrs.items():
        setattr(model, key, value)
    shapes = {"bn": [], "abn": []}

    def hook(kind):
        return lambda mod, inp: shapes[kind].append(tuple(inp[0].shape))

    handles = [m.register_forward_pre_hook(hook("bn" if isinstance(m, BatchNormTorch) else "abn"))
               for m in model.modules() if isinstance(m, (BatchNormTorch, InPlaceABN))]
    x = torch.zeros(batch, 3, patch, patch, device=device).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad(), torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
        model(x)
    for h in handles:
        h.remove()
    want = NORM_LAYERS[model_name]
    if (len(shapes["bn"]), len(shapes["abn"])) != want:
        raise AssertionError(f"expected {want[0]} BN and {want[1]} ABN layers in {model_name}, "
                             f"found {len(shapes['bn'])} and {len(shapes['abn'])}")
    return shapes


def _input(shape, g, mean, std, device, dtype=torch.bfloat16):
    """A seeded NCHW tensor in ``dtype``, channels_last."""
    x = (torch.randn(shape, device=device, generator=g) * std + mean).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def b1_inputs(shape, pair: bool, g, device="cuda"):
    """(a, b): seeded bf16 inputs of B1; b is None for the single form."""
    a = _input(shape, g, 0.3, 2.0, device)
    return a, (_input(shape, g, 0.0, 1.0, device) if pair else None)


def b3_inputs(shape, g, device="cuda", activation="leaky_relu"):
    """(z, grad, gamma, beta) of B3: z = act(y) in bf16 for a seeded
    pre-activation y of both signs."""
    from segtpu_torch.ops.abn import act_forward

    c = shape[1]
    gamma = torch.rand(c, device=device, generator=g) + 0.5
    beta = torch.randn(c, device=device, generator=g) * 0.3
    z = act_forward(_input(shape, g, 0.0, 1.0, device, torch.float32), activation, SLOPE)
    z = z.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return z, _input(shape, g, 0.0, 1.0, device), gamma, beta


def _worst(got, ref, magnitude):
    """Largest |got - ref| / magnitude over the channels of both sums."""
    return max(float(((x.double() - r).abs() / m.clamp_min(1e-300)).max())
               for x, r, m in zip(got, ref, magnitude))


def b1_errors(a, b):
    """B1 (``abn.channel_sums``: the kernel on the card, the plain version
    on the CPU) and the plain fp32 version against float64 sums of the same
    inputs, as the largest |error| / sum|term| per channel."""
    from segtpu_torch.ops import abn

    ref = abn.channel_sums_plain(a.double(), None if b is None else b.double())
    magnitude = abn.channel_sums_plain(a.double().abs(), None if b is None else b.double().abs())
    return {"kernel": _worst(abn.channel_sums(a, b), ref, magnitude),
            "plain_fp32": _worst(abn.channel_sums_plain(a, b), ref, magnitude)}


def b3_errors(z, grad, gamma, beta, activation="leaky_relu"):
    """B3 (``abn.abn_bwd_sums``) and its plain fp32 version against float64
    sums of the same inputs, as in :func:`b1_errors`."""
    from segtpu_torch.ops import abn

    zd, gd = z.double(), grad.double()
    view = (1, z.shape[1]) + (1,) * (z.dim() - 2)
    ref = abn.abn_bwd_sums_plain(zd, gd, gamma.double(), beta.double(), activation, SLOPE)
    dy = (gd * abn.act_grad_from_output(zd, activation, SLOPE)).abs()
    xhat = ((abn.act_invert(zd, activation, SLOPE) - beta.double().view(view))
            / gamma.double().view(view)).abs()
    dims = (0,) + tuple(range(2, z.dim()))
    magnitude = (dy.sum(dims), (xhat * dy).sum(dims))
    return {"kernel": _worst(abn.abn_bwd_sums(z, grad, gamma, beta, activation, SLOPE), ref,
                             magnitude),
            "plain_fp32": _worst(abn.abn_bwd_sums_plain(z, grad, gamma, beta, activation, SLOPE),
                                 ref, magnitude)}


def main(argv=None) -> int:
    from segtpu_torch.ops import kernels

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)

    resolve_device("cuda")  # a measurement of the card: no card, no run
    shapes = step_norm_shapes()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    accuracy = {"b1_single": [], "b1_pair": [], "b3_leaky_relu": []}
    for shape in sorted(set(shapes["bn"] + shapes["abn"])):
        for form, pair in (("b1_single", False), ("b1_pair", True)):
            accuracy[form].append(dict(shape=list(shape), **b1_errors(*b1_inputs(shape, pair, g))))
    for shape in sorted(set(shapes["abn"])):
        accuracy["b3_leaky_relu"].append(dict(shape=list(shape), **b3_errors(*b3_inputs(shape, g))))
    worst = {form: {k: max(r[k] for r in rows) for k in ("kernel", "plain_fp32")}
             for form, rows in accuracy.items()}

    big = max(shapes["abn"], key=lambda s: int(np.prod(s)))
    a, b = b1_inputs(big, True, g)
    z, grad, gamma, beta = b3_inputs(big, g)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    calls = {"b1_single": lambda: kernels.channel_sums_cuda(a),
             "b1_pair": lambda: kernels.channel_sums_cuda(a, b),
             "b3_leaky_relu": lambda: kernels.abn_bwd_sums_cuda(z, grad, gamma, beta,
                                                                "leaky_relu", SLOPE)}
    times = {k: {"ms_warm": cuda_ms(fn), "ms_cold": cuda_ms(fn, flush=flush)}
             for k, fn in calls.items()}

    smi = card_line()
    result = {"card": smi, "largest_shape": list(big), "dtype": "bfloat16",
              "layout": "channels_last", "times_ms": times,
              "timing": "device time (a spin kernel ahead of each run), medians of 20; "
                        "cold: L2 flushed before each run",
              "max_err_over_sum_abs_vs_float64": worst, "per_shape": accuracy}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
