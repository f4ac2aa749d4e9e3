"""Where the device time of the port's training step goes, on one GPU.

    python -m segtpu_torch.profile_train [--config zf_unet-512] [--no-s2d] [--out profile_train.json]

Runs the training step of a bench config (``segtpu_torch.bench``; default
``linknet34-bce_jaccard-adam-512``, the step of ``chip_smoke.py``'s train
phase) as the bench does: random weights from a seed, its batch and patch,
bf16 autocast, its loss and optimizer at lr 1e-3, its frozen encoder, its
form (s2d for ``zf_unet-512`` and ``unet11-finetune-512`` unless given
``--no-s2d``), one fixed DeviceShapes batch; 3 warm steps, then 3 steps under ``torch.profiler``. Prints one JSON
object: the wall milliseconds per step, the device-busy milliseconds per
step (the union of all kernel intervals) and the idle share, the kernel
launches per step, the peak memory, and the device time per step by kernel
group and by kernel name. Fails when the
trace holds no device kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from segtpu_torch.bench import BENCH_CONFIGS
from segtpu_torch.data.shapes import DeviceShapes
from segtpu_torch.models import get_model, without_encoder
from segtpu_torch.ops.losses import get_loss
from segtpu_torch.ops.metrics import default_metrics
from segtpu_torch.profile_serve import group_of, union_ms
from segtpu_torch.train.optim import get_optimizer
from segtpu_torch.train.state import make_train_step

SEED, LR, WARMUP, STEPS = 0, 1e-3, 3, 3

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="linknet34-bce_jaccard-adam-512",
                        choices=sorted(BENCH_CONFIGS))
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--no-s2d", action="store_true",
                        help="run zf_unet-512 and unet11-finetune-512 in normal space")
    args = parser.parse_args(argv)

    cfg = BENCH_CONFIGS[args.config]
    model = get_model(cfg["model_name"], patch_size=cfg["patch"], device="cuda", seed=SEED)
    s2d = cfg.get("s2d", False) and not args.no_s2d
    if s2d:
        model.s2d = True
    trainable = (without_encoder(cfg["model_name"], (n for n, _ in model.named_parameters()))
                 if cfg.get("freeze_encoder") else None)
    step = make_train_step(model, get_optimizer(cfg["optimizer"], model.parameters(), LR),
                           get_loss(cfg["loss_name"]), default_metrics(), bf16=True,
                           trainable_mask=trainable)
    x, y = DeviceShapes(cfg["patch"], device="cuda").batch(
        cfg["batch_size"], torch.Generator(device="cuda").manual_seed(SEED))
    for _ in range(WARMUP):
        step(x, y, LR)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(x, y, LR)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side kernels and copies; the GPU-side ranges of user annotations
    # (such as ``Optimizer.step#Adam.step``) span kernels and are left out
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise SystemExit("profile_train: the trace holds no device kernels")
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / STEPS
        by_name[e.name] += ms
        by_group[group_of(e.name, GROUPS)] += ms
    busy_ms = union_ms((e.time_range.start, e.time_range.end) for e in kernels) / STEPS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    result = {
        "card": smi, "config": args.config, "form": "s2d" if s2d else "normal",
        "batch": cfg["batch_size"], "patch": cfg["patch"],
        "steps": STEPS, "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_ms_per_step": wall_ms / STEPS, "device_busy_ms_per_step": busy_ms,
        "idle_share_of_wall": 1.0 - busy_ms * STEPS / wall_ms,
        "kernel_ms_per_step": sum(by_name.values()), "kernels_per_step": len(kernels) / STEPS,
        "by_group_ms_per_step": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [{"name": n[:120], "ms": ms} for n, ms in top],
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
