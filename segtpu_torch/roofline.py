"""Roofline of the port's training step on one GPU (counterpart of segtpu's
tools/roofline.py).

    python -m segtpu_torch.roofline --config zf_unet-512 [--no-s2d]
    python -m segtpu_torch.roofline --model zf_unet --patch 512 --batch 16 [--s2d]
    python -m segtpu_torch.roofline --all
    python -m segtpu_torch.roofline --sweep

For a bench config (``segtpu_torch.bench``; ``--all``: the five training
configs, #1 and #3 in both forms) or a model, patch and batch:
the model FLOPs of one training step, the measured step time (3 warm steps,
then 20 timed between CUDA synchronisations), the achieved TFLOP/s and the
model FLOP utilisation ``mfu_pct`` against the card's dense bf16 peak, and
the bytes that the step's ops move as the port writes them. Prints one JSON
object with the card's name and power limit (``nvidia-smi``).

**FLOPs are the model's, not the executed program's** (:func:`step_flops`):
``torch.utils.flop_counter.FlopCounterMode`` over one forward and backward
of the model's normal-space twin without remat, with only the parameters
the config trains requiring a gradient (``without_encoder`` for the
finetune configs: the frozen encoder has neither a weight gradient nor a
data gradient) and an input that does not. Convolutions (forward, data
gradient, weight gradient) and matrix products count; normalisation,
activations, losses and the optimizer do not, and neither do B1/B2/B3 and
the dx pass, which the counter does not see. The count is taken at batch 1 and scaled by
the batch: a convolution's FLOPs are linear in it. segtpu took XLA's cost
analysis of the compiled step instead, which grows with the s2d form's
expanded kernels (138.2 -> 183.1 forward GFLOP per 512^2 zf_unet image) and
would grow with remat; a count of the model's work stays the same whatever
form, kernel or remat runs it, so the share built on it cannot be moved by
changing the implementation.

Peak: 989 TFLOP/s, NVIDIA's data-sheet dense bf16 rate of the H100 SXM at
700 W, and 3.35 TB/s of HBM; another card needs ``--peak-tflops`` (and
``--peak-hbm-gbs``).

Bytes, ``gb_ops_per_step`` and ``hbm_ops_pct``: one step under a
``TorchDispatchMode`` that charges each aten op its tensor inputs read once
and its outputs written once (views move nothing), and each B1/B2/B3 or
dx-pass call its inputs and outputs from their shapes (:func:`segtpu_torch.ops.abn`'s
dispatcher). This is the traffic of the ops as written, not a lower bound:
nothing gates on it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from segtpu_torch import bench
from segtpu_torch.device import DeviceLike, card_line, resolve_device
from segtpu_torch.models import get_model, without_encoder
from segtpu_torch.ops import abn as abn_ops

# (card name fragment, dense bf16 FLOP/s, HBM bytes/s), NVIDIA's data sheet
# of the H100 SXM at 700 W; torch names that card "NVIDIA H100 80GB HBM3"
PEAKS = (("H100 80GB HBM3", 989e12, 3.35e12), ("H100 SXM", 989e12, 3.35e12))
STEPS, WARMUP, LR = 20, 3, 1e-3
# --all: each training config, and normal space for those whose default is s2d
ALL_RUNS = tuple((name, False) for name in sorted(bench.BENCH_CONFIGS)) + tuple(
    (name, True) for name in sorted(bench.BENCH_CONFIGS) if bench.BENCH_CONFIGS[name].get("s2d"))
# the training-step arguments of a bench config that the roofline takes
_STEP_KEYS = ("model_name", "patch", "batch_size", "loss_name", "optimizer", "freeze_encoder",
              "s2d")
# tools/roofline.py:127-156: (model, patch, batch, s2d)
SWEEP = (
    ("unet", 224, 32, False), ("unet", 224, 32, True),
    ("zf_unet", 224, 32, False), ("zf_unet", 224, 32, True),
    ("linknet34", 224, 32, False), ("albunet", 224, 32, False),
    ("unet11", 224, 32, False), ("unet11", 224, 32, True),
    ("unet16", 224, 32, False), ("unet16", 224, 32, True),
    ("linknext", 224, 32, False), ("linknext", 224, 32, True),
    ("dilated_linknet34", 224, 32, False),
    ("squeezenet", 224, 32, False), ("squeezenet", 224, 32, True),
    ("gcn34", 224, 32, False), ("gcn", 224, 16, False), ("psp_net", 224, 16, False),
    ("duc", 224, 16, False), ("duc_dc", 224, 16, False),
    ("tiramisu57", 224, 16, False), ("tiramisu67", 224, 16, False),
    ("tiramisu103", 224, 8, False),
    ("unet_abn", 224, 32, False), ("unet_abn", 224, 32, True),
    ("zf_unet", 512, 16, False), ("zf_unet", 512, 16, True),
)


def card_peaks(name: str, peak_tflops: Optional[float] = None,
               peak_hbm_gbs: Optional[float] = None):
    """``(FLOP/s, bytes/s, source)`` of the card called ``name``: the given
    peaks, else the data-sheet ones of :data:`PEAKS`. Raises SystemExit for a
    card with no known peak and none given."""
    known = next(((f, b) for key, f, b in PEAKS if key in name), None)
    if peak_tflops is None and known is None:
        raise SystemExit(f"roofline: no known bf16 peak for '{name}'; pass --peak-tflops "
                         "(and --peak-hbm-gbs)")
    flops = peak_tflops * 1e12 if peak_tflops is not None else known[0]
    hbm = (peak_hbm_gbs * 1e9 if peak_hbm_gbs is not None
           else known[1] if known is not None else None)
    source = ("given" if peak_tflops is not None
              else "NVIDIA data sheet, H100 SXM dense bf16 at 700 W")
    return flops, hbm, source


def flop_twin(model_name: str, patch: int, device: DeviceLike = "cpu", seed: int = 0,
              freeze_encoder: bool = False, model: Optional[torch.nn.Module] = None
              ) -> torch.nn.Module:
    """The model whose work is counted: ``model_name`` (or ``model``, a
    built one of that name's family) in normal space without remat, in
    training mode, its frozen encoder (``freeze_encoder``) not requiring a
    gradient."""
    if model is None:
        model = get_model(model_name, patch_size=patch, device=device, seed=seed)
    for attr, value in (("s2d", False), ("remat", False), ("packed", False),
                        ("remat_policy", None)):
        if hasattr(model, attr):
            setattr(model, attr, value)
    names = [n for n, _ in model.named_parameters()]
    trained = set(without_encoder(model_name, names)) if freeze_encoder else set(names)
    for n, p in model.named_parameters():
        p.requires_grad_(n in trained)
    return model.train()


def count_flops(model: torch.nn.Module, x: torch.Tensor, backward: bool = True) -> int:
    """FLOPs that ``FlopCounterMode`` counts in ``model(x)`` and, with
    ``backward``, in the backward of the output's sum; without ``backward``
    the forward runs without autograd."""
    with FlopCounterMode(display=False) as counter:
        if backward:
            model(x).float().sum().backward()
        else:
            with torch.no_grad():
                model(x)
    return counter.get_total_flops()


def step_flops(model_name: str, patch: int, batch: int, freeze_encoder: bool = False,
               device: DeviceLike = "cpu", seed: int = 0, count_batch: int = 1,
               model: Optional[torch.nn.Module] = None) -> float:
    """The model FLOPs of one training step at ``batch`` (module docstring):
    counted at ``count_batch`` and scaled to ``batch``; ``model``: as of
    :func:`flop_twin`."""
    dev = resolve_device(device)
    model = flop_twin(model_name, patch, dev, seed, freeze_encoder, model)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(count_batch, 3, patch, patch, generator=g).to(dev)
    return count_flops(model, x) * batch / count_batch


def forward_flops(model_name: str, patch: int, device: DeviceLike = "cpu", seed: int = 0) -> int:
    """The model FLOPs of one eval forward of one ``patch``^2 image."""
    dev = resolve_device(device)
    model = flop_twin(model_name, patch, dev, seed).eval()
    x = torch.randn(1, 3, patch, patch, generator=torch.Generator().manual_seed(seed)).to(dev)
    return count_flops(model, x, backward=False)


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def kernel_bytes(name: str, x: torch.Tensor, *args) -> int:
    """Bytes that one B1/B2/B3 or dx-pass call reads and writes, from its
    shapes: its tensor inputs once each, and its outputs (B1, B3: two fp32
    [C] sums; B2 and the dx pass: a tensor like ``x``)."""
    inputs = x.nbytes + _nbytes(args)
    if name in ("abn_norm_act", "bn_dx"):
        return inputs + x.nbytes
    return inputs + 2 * 4 * x.shape[1 if x.dim() > 1 else 0]


class OpBytes(TorchDispatchMode):
    """Bytes of the aten ops run under it, as the module docstring counts
    them; :meth:`on_device` wraps the kernels' dispatcher to charge each
    call :func:`kernel_bytes` (the ops inside a plain version are not
    charged)."""

    _SKIP = ("empty", "empty_like", "empty_strided", "_local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.bytes = self.kernel_bytes = self.ops = self.kernel_calls = 0
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._inside and not getattr(func, "is_view", False) \
                and func.overloadpacket.__name__ not in self._SKIP:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out

    def on_device(self, dispatch):
        def counted(name, x, cuda_fn, plain_fn, *args):
            self.kernel_bytes += kernel_bytes(name, x, *args)
            self.kernel_calls += 1
            self._inside += 1
            try:
                return dispatch(name, x, cuda_fn, plain_fn, *args)
            finally:
                self._inside -= 1
        return counted


def step_bytes(step, x, y, lr: float = LR) -> dict:
    """The bytes of one ``step(x, y, lr)`` under :class:`OpBytes`."""
    counter, dispatch = OpBytes(), abn_ops._on_device
    abn_ops._on_device = counter.on_device(dispatch)
    try:
        with counter:
            step(x, y, lr)
    finally:
        abn_ops._on_device = dispatch
    return dict(ops_bytes=counter.bytes, kernel_bytes=counter.kernel_bytes, ops=counter.ops,
                kernel_calls=counter.kernel_calls)


def step_args(config: Optional[str] = None, no_s2d: bool = False, **explicit) -> dict:
    """The training-step arguments of bench config ``config`` (``no_s2d``:
    normal space for a config whose default is s2d), else ``explicit``."""
    if config is None:
        return dict(explicit)
    args = {k: v for k, v in bench.BENCH_CONFIGS[config].items() if k in _STEP_KEYS}
    args["s2d"] = args.get("s2d", False) and not no_s2d
    return args


def analyze(config: Optional[str] = None, no_s2d: bool = False, steps: int = STEPS,
            warmup: int = WARMUP, device: DeviceLike = None, peak_tflops: Optional[float] = None,
            peak_hbm_gbs: Optional[float] = None, with_bytes: bool = True, seed: int = 0,
            **explicit) -> dict:
    """One roofline row: a bench ``config`` or the ``explicit`` arguments of
    :func:`segtpu_torch.bench.build_train_step` (``model_name``, ``patch``,
    ``batch_size``, ...). The shares against the peaks are None on a device
    without a known or given peak (the CPU)."""
    dev = resolve_device(device)
    args = step_args(config, no_s2d, **explicit)
    args.setdefault("batch_size", 16)
    args.setdefault("patch", 512)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = (card_peaks(name, peak_tflops, peak_hbm_gbs)
             if dev.type == "cuda" or peak_tflops is not None else (None, None, None))
    flops = step_flops(args["model_name"], args["patch"], args["batch_size"],
                       args.get("freeze_encoder", False), dev, seed)
    step, x, y, _model, info = bench.build_train_step(device=dev, seed=seed, lr=LR, **args)
    moved = step_bytes(step, x, y) if with_bytes else None
    for _ in range(warmup):
        step(x, y, LR)
    bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = step(x, y, LR)
    loss = float(logs["loss"])
    bench._sync(dev)
    dt = (time.perf_counter() - t0) / steps
    if loss != loss:
        raise FloatingPointError("non-finite loss in the roofline's step")
    tflops = flops / dt / 1e12
    row = {
        "config": config, "model": args["model_name"], "form": info["form"],
        "patch": args["patch"], "batch": args["batch_size"],
        "freeze_encoder": bool(args.get("freeze_encoder", False)),
        "gflop_per_step": flops / 1e9, "step_ms": dt * 1e3, "img_per_s": args["batch_size"] / dt,
        "achieved_tflops": tflops,
        "mfu_pct": None if peaks[0] is None else 100 * tflops * 1e12 / peaks[0],
        "peak_tflops": None if peaks[0] is None else peaks[0] / 1e12, "peak_source": peaks[2],
        "flops": "model FLOPs: normal space, no remat, trained parameters only "
                 "(FlopCounterMode at batch 1, times the batch)",
        "steps": steps, "device": name,
        "card": card_line() if dev.type == "cuda" else "cpu",
    }
    if moved is not None:
        gb = (moved["ops_bytes"] + moved["kernel_bytes"]) / 1e9
        row.update(gb_ops_per_step=gb, kernel_gb_per_step=moved["kernel_bytes"] / 1e9,
                   aten_ops_per_step=moved["ops"], kernel_calls_per_step=moved["kernel_calls"],
                   hbm_ops_pct=None if peaks[1] is None else 100 * gb * 1e9 / dt / peaks[1],
                   bytes="the step's ops as written (aten inputs read once, outputs written "
                         "once; B1/B2/B3 and the dx pass from their shapes): not a lower bound")
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None, choices=sorted(bench.BENCH_CONFIGS))
    p.add_argument("--no-s2d", action="store_true",
                   help="run zf_unet-512 and unet11-finetune-512 in normal space")
    p.add_argument("--model", default="zf_unet")
    p.add_argument("--patch", type=int, default=512)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--loss", default="bce")
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--freeze-encoder", action="store_true")
    p.add_argument("--s2d", action="store_true")
    p.add_argument("--packed", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", default=None)
    p.add_argument("--fp32", action="store_true", help="run the step without bf16 autocast")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the card's dense bf16 peak (needed for a card other than the H100 SXM)")
    p.add_argument("--peak-hbm-gbs", type=float, default=None)
    p.add_argument("--all", action="store_true",
                   help="the five training configs, #1 and #3 also in normal space")
    p.add_argument("--sweep", action="store_true", help="tools/roofline.py's model list")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.add_argument("--out", default=None, help="also write the JSON rows here")
    args = p.parse_args(argv)
    common = dict(steps=args.steps, device=args.device, peak_tflops=args.peak_tflops,
                  peak_hbm_gbs=args.peak_hbm_gbs)
    rows = []
    if args.sweep:
        for model, patch, batch, s2d in SWEEP:
            try:
                row = analyze(model_name=model, patch=patch, batch_size=batch, loss_name="bce",
                              optimizer="sgd", s2d=s2d, **common)
            except (RuntimeError, ValueError) as e:  # out of memory, a shape; go on
                row = {"model": model, "form": "s2d" if s2d else "normal", "patch": patch,
                       "batch": batch, "error": str(e)[:200]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    elif args.all:
        for config, no_s2d in ALL_RUNS:
            rows.append(analyze(config, no_s2d=no_s2d, **common))
            print(json.dumps(rows[-1]), flush=True)
            if args.device in (None, "cuda"):
                torch.cuda.empty_cache()
    else:
        if args.config is not None:
            row = analyze(args.config, no_s2d=args.no_s2d, **common)
        else:
            attrs = {k: v for k, v in (("packed", args.packed), ("remat", args.remat),
                                       ("remat_policy", args.remat_policy)) if v}
            row = analyze(model_name=args.model, patch=args.patch, batch_size=args.batch,
                          loss_name=args.loss, optimizer=args.optimizer,
                          freeze_encoder=args.freeze_encoder, s2d=args.s2d,
                          bf16=not args.fp32, **attrs, **common)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
