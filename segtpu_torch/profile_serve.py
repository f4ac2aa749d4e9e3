"""Where the device time of the port's serving path goes, on one GPU.

    python -m segtpu_torch.profile_serve [--out profile_serve.json]

Serves one seeded 5000x5000 uint8 image the way ``chip_smoke.py``'s serve
phase does (LinkNet34, random weights from a seed, patch 512, batch 64, D4
TTA, pyramid weights, bf16, threshold 0.5) after one warm image, under
``torch.profiler``. Prints one JSON object: the wall seconds of the image,
the device-busy milliseconds (the union of all kernel intervals) and the idle
share, and the device time by kernel group and by kernel name. Fails when
the trace holds no device kernels.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from segtpu_torch.augment import host as aug
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.device import card_line
from segtpu_torch.inference import predict_tiled
from segtpu_torch.models import get_model
from segtpu_torch.train.state import make_predict_step

SEED = 0

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("abn_norm_act", "B2 fused BN+activation (this repo)"),
    ("bn_fw_inf", "BatchNorm eval"),
    ("batch_norm", "BatchNorm eval"),
    ("col2im", "tile merge (fold)"),
    ("dgrad", "transposed convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("xmma", "convolution (cuDNN)"),
    ("gemm", "convolution (cuDNN)"),
    ("nchwToNhwc", "layout transform"),
    ("nhwcToNchw", "layout transform"),
    ("max_pool", "max pool"),
    ("CUDAFunctor_add", "add (conv bias, residual and skip adds, TTA average)"),
    ("clamp", "ReLU (clamp)"),
    ("leaky_relu", "LeakyReLU (head)"),
)


def group_of(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for frag, group in groups:
        if frag.lower() in low:
            return group
    return "other elementwise / copies"


def union_ms(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)

    model = get_model("linknet34", patch_size=512, device="cuda", seed=SEED)
    fn = make_predict_step(model, bf16=True)
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    rng = np.random.default_rng(SEED)
    warm, image = (rng.integers(0, 256, (5000, 5000, 3), dtype=np.uint8) for _ in range(2))
    kw = dict(test_transform=transform, patch_size=512, batch_size=64, tta=True,
              weight="pyramid", threshold=0.5, device="cuda")
    predict_tiled(warm, fn, **kw)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict_tiled(image, fn, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_serve: the trace holds no device kernels")
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] += ms
        by_group[group_of(e.name)] += ms
    busy_ms = union_ms((e.time_range.start, e.time_range.end) for e in kernels)
    span_ms = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    smi = card_line()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "card": smi, "wall_s": wall_s, "device_busy_ms": busy_ms, "kernel_span_ms": span_ms,
        "idle_share_of_wall": 1.0 - busy_ms / (wall_s * 1e3),
        "kernel_ms_total": sum(by_name.values()), "n_kernels": len(kernels),
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [{"name": n[:120], "ms": ms} for n, ms in top],
    }
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
