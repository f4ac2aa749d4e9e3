"""Speed-of-light bound of the BatchNorm reductions in a training step on
one GPU (counterpart of segtpu's tools/bn_sol.py).

    python -m segtpu_torch.bn_sol --config linknet34-bce_jaccard-adam-512 [--no-s2d]
    python -m segtpu_torch.bn_sol --all

What the step time would be if every training-BatchNorm reduction ran at
the HBM rate. The sites are the inputs of the step's BatchNorm and
InPlaceABN layers (``profile_reduce.step_norm_shapes``, one forward of the
config's model, batch and patch in its form under bf16 autocast); each is
charged its irreducible reduce-read bytes, 3x its activation bytes:

  * forward statistics: one read of x (B1: sum, sum of squares);
  * backward sums: one read of x (or of z, B3) and one of the gradient
    (B1's pair form, or B3).

The bound is ``measured step - measured B1/B3 time + those bytes at 3.35
TB/s``, with the step's wall milliseconds (timed without the profiler) and
its B1 and B3 device milliseconds per step from ``profile_train``
(torch.profiler over the bench config's steps). Prints one JSON object with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from typing import List, Tuple

from segtpu_torch.bench import BENCH_CONFIGS
from segtpu_torch.device import DeviceLike

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's data sheet, H100 SXM at 700 W
BF16_BYTES = 2
# profile_train's groups of the reduction kernels
REDUCE_GROUPS = ("B1 channel sums (this repo)", "B3 ABN backward sums (this repo)")


def bn_sites(model_name: str, patch: int, batch: int, s2d: bool = False,
             device: DeviceLike = "cpu") -> List[Tuple[Tuple[int, ...], int]]:
    """``[(NCHW shape, bytes)]`` of every training-BatchNorm input of one
    step, BatchNorm layers first, then InPlaceABN, each in layer order; bf16
    as autocast hands them over."""
    from segtpu_torch.profile_reduce import step_norm_shapes

    attrs = {"s2d": True} if s2d else {}
    shapes = step_norm_shapes(batch, patch, device, model_name, **attrs)
    return [(tuple(s), BF16_BYTES * _numel(s)) for s in shapes["bn"] + shapes["abn"]]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def sol(sites, hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> dict:
    """The sites' activation bytes, their 3x reduce-read bytes and the time
    of those at ``hbm_bytes_per_s``."""
    act = sum(b for _, b in sites)
    return dict(sites=len(sites), activation_gb=act / 1e9, reduce_read_gb=3 * act / 1e9,
                sol_reduce_ms=3 * act / hbm_bytes_per_s * 1e3)


def bound(step_ms: float, reduce_ms: float, sol_ms: float, batch: int) -> dict:
    """The step bound with the reductions at the HBM rate, and its images/s
    beside the measured one."""
    b = step_ms - reduce_ms + sol_ms
    return dict(step_bound_ms=b, img_per_s_bound=batch / b * 1e3,
                img_per_s_measured=batch / step_ms * 1e3)


def analyze(config: str, no_s2d: bool = False) -> dict:
    """The sites, their speed of light and the bound of bench ``config`` on
    the card (its step profiled by ``profile_train``)."""
    from segtpu_torch.profile_train import profile_step

    cfg = BENCH_CONFIGS[config]
    s2d = cfg.get("s2d", False) and not no_s2d
    sites = bn_sites(cfg["model_name"], cfg["patch"], cfg["batch_size"], s2d, "cuda")
    light = sol(sites)
    prof = profile_step(config, no_s2d)
    groups = prof["by_group_ms_per_step"]
    reduce_ms = sum(groups.get(g, 0.0) for g in REDUCE_GROUPS)
    by_shape = Counter(shape for shape, _ in sites)
    return dict(
        config=config, form=prof["form"], card=prof["card"], batch=cfg["batch_size"],
        patch=cfg["patch"], **light,
        sites_by_shape=[{"shape": list(s), "count": n} for s, n in by_shape.most_common()],
        step_ms=prof["wall_ms_per_step_unprofiled"],
        profiled_step_ms=prof["wall_ms_per_step"], device_busy_ms=prof["device_busy_ms_per_step"],
        b1_ms=groups.get(REDUCE_GROUPS[0], 0.0), b3_ms=groups.get(REDUCE_GROUPS[1], 0.0),
        reduce_ms=reduce_ms, **bound(prof["wall_ms_per_step_unprofiled"], reduce_ms,
                                     light["sol_reduce_ms"], cfg["batch_size"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="linknet34-bce_jaccard-adam-512",
                   choices=sorted(BENCH_CONFIGS))
    p.add_argument("--no-s2d", action="store_true",
                   help="zf_unet-512 and unet11-finetune-512 in normal space")
    p.add_argument("--all", action="store_true", help="every training config in its form")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    results = []
    for config in sorted(BENCH_CONFIGS) if args.all else [args.config]:
        results.append(analyze(config, args.no_s2d))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results if args.all else results[0], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
