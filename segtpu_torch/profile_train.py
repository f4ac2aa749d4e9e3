"""Where the device time of the port's training step goes, on one GPU.

    python -m segtpu_torch.profile_train [--config zf_unet-512] [--no-s2d] [--out profile_train.json]

Runs the training step of a bench config (``segtpu_torch.bench``; default
``linknet34-bce_jaccard-adam-512``, the step of ``chip_smoke.py``'s train
phase) as the bench does: random weights from a seed, its batch and patch,
bf16 autocast, its loss and optimizer at lr 1e-3, its frozen encoder, its
form (s2d for ``zf_unet-512`` and ``unet11-finetune-512`` unless given
``--no-s2d``), one fixed DeviceShapes batch; 3 warm steps, 10 timed without
the profiler, then 3 under ``torch.profiler``. Prints one JSON object: the
wall milliseconds per step with and without the profiler, the device-busy
milliseconds per
step (the union of all kernel intervals) and the idle share, the kernel
launches per step, the peak memory, and the device time per step by kernel
group and by kernel name. Fails when three profiles in a row hold no device
kernels.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from segtpu_torch.bench import BENCH_CONFIGS, build_train_step
from segtpu_torch.device import card_line
from segtpu_torch.profile_serve import group_of, union_ms

SEED, LR, WARMUP, STEPS = 0, 1e-3, 3, 3
UNPROFILED_STEPS = 10

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("SumsOp", "B1 channel sums (this repo)"),
    ("AbnBwdOp", "B3 ABN backward sums (this repo)"),
    ("abn_norm_act", "B2 affine+activation (this repo)"),
    ("wgrad", "convolution weight gradient (cuDNN)"),
    ("dgrad", "convolution data gradient / transposed conv (cuDNN)"),
    ("fprop", "convolution forward (cuDNN)"),
    ("xmma", "convolution other (cuDNN)"),
    ("conv", "convolution other (cuDNN)"),
    ("gemm", "convolution other (cuDNN)"),
    ("nchwToNhwc", "layout transform"),
    ("nhwcToNchw", "layout transform"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("max_pool", "max pool"),
    ("upsample", "nearest upsampling"),
    ("CatArray", "concatenation"),
    ("bernoulli", "dropout masks"),
    ("reduce_kernel", "reductions (loss, metrics, bias grads, grad abs-max)"),
    ("elementwise", "elementwise (dx passes, casts, activations, adds)"),
    ("copy", "copies"),
)


def profile_step(config: str = "linknet34-bce_jaccard-adam-512", no_s2d: bool = False,
                 warmup: int = WARMUP, steps: int = STEPS) -> dict:
    """The breakdown of the module docstring for one bench config: its step
    as the bench builds it, ``warmup`` steps, then ``steps`` under the
    profiler."""
    cfg = BENCH_CONFIGS[config]
    s2d = cfg.get("s2d", False) and not no_s2d
    step, x, y, _model, _info = build_train_step(
        cfg["batch_size"], cfg["patch"], model_name=cfg["model_name"], lr=LR,
        loss_name=cfg["loss_name"], optimizer=cfg["optimizer"],
        freeze_encoder=cfg.get("freeze_encoder", False), device="cuda", seed=SEED, s2d=s2d)
    for _ in range(warmup):
        step(x, y, LR)
    torch.cuda.synchronize()
    # the same steps without the profiler, whose per-op work slows a
    # host-bound step
    t0 = time.perf_counter()
    for _ in range(UNPROFILED_STEPS):
        step(x, y, LR)
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / UNPROFILED_STEPS

    # a process's first profile once came back with no device event at all
    # (an H100): an empty profile is taken again, three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(x, y, LR)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side kernels and copies; the GPU-side ranges of user
        # annotations (such as ``Optimizer.step#Adam.step``) span kernels and
        # are left out
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if kernels:
            break
    else:
        raise SystemExit("profile_train: the trace holds no device kernels")
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        by_name[e.name] += ms
        by_group[group_of(e.name, GROUPS)] += ms
    busy_ms = union_ms((e.time_range.start, e.time_range.end) for e in kernels) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {
        "card": card_line(), "config": config, "form": "s2d" if s2d else "normal",
        "batch": cfg["batch_size"], "patch": cfg["patch"],
        "steps": steps, "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_ms_per_step": wall_ms / steps, "wall_ms_per_step_unprofiled": unprofiled_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share_of_wall": 1.0 - busy_ms * steps / wall_ms,
        "kernel_ms_per_step": sum(by_name.values()), "kernels_per_step": len(kernels) / steps,
        "by_group_ms_per_step": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [{"name": n[:120], "ms": ms} for n, ms in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="linknet34-bce_jaccard-adam-512",
                        choices=sorted(BENCH_CONFIGS))
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--no-s2d", action="store_true",
                        help="run zf_unet-512 and unet11-finetune-512 in normal space")
    args = parser.parse_args(argv)
    result = profile_step(args.config, args.no_s2d)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
