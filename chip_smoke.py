"""Smoke run of the PyTorch/CUDA port (``segtpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  device       the card (nvidia-smi name and power limit), torch and CUDA versions
  build        nvcc build of every CUDA kernel of segtpu_torch/csrc, in seconds
  kernel_b2    the fused BN+activation kernel against its plain PyTorch version
               (fp32/bf16, channels_last/NCHW, three activations, a ragged
               tail, and the twelve decoder shapes of a LinkNet34 pass at tile
               batch 64), with its time, bytes and bound at the largest shape
  model_parity LinkNet34 saved and reloaded through the .pth snapshot format,
               one 2x3x512x512 fp32 eval forward on the card vs the CPU
  serve        tiled inference as the submit CLI runs it (patch 512, batch 64,
               D4 TTA, pyramid weights, threshold 0.5, bf16, depth 2) over two
               seeded 5000x5000 uint8 images after one warm image; s/image,
               peak memory and kernel launches, plus bf16-vs-fp32 masks and a
               small-image card-vs-CPU parity check

Then the kernel table line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Weights are random, drawn from a seed,
with the normalisation statistics set from one calibration batch so that every
layer sees activations of order one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from segtpu_torch.augment import host as aug
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.inference import predict_tiled, predict_tiled_stream
from segtpu_torch.models import get_model
from segtpu_torch.models.layers import BatchNormTorch, InPlaceABN
from segtpu_torch.ops import kernels
from segtpu_torch.ops.abn import abn_norm_act_plain
from segtpu_torch.train.checkpoint import load_snapshot, save_snapshot
from segtpu_torch.train.state import make_predict_step

SEED = 0
PATCH, BATCH, IMAGE_SIDE, N_IMAGES, DEPTH = 512, 64, 5000, 2, 2
SLOPE = 0.01

# Device-memory rate (bytes/s) and fp32 CUDA-core rate (FLOP/s) by card name,
# from NVIDIA's data sheets; the first matching key wins.
CARD_RATES = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "unknown card: H100 SXM rates assumed"


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with its
    own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def decoder_abn_shapes(batch: int, patch: int):
    """Input shapes of the twelve InPlaceABN layers of one LinkNet34 pass, in
    order (decoder4 .. decoder1; abn1, abn2, abn3 each)."""
    shapes, s = [], patch // 32
    for cin, cout in ((512, 256), (256, 128), (128, 64), (64, 64)):
        mid = cin // 4
        shapes += [(batch, mid, s, s), (batch, mid, 2 * s, 2 * s), (batch, cout, 2 * s, 2 * s)]
        s *= 2
    return shapes


def calibrate_norms(model: torch.nn.Module, x: torch.Tensor) -> None:
    """Set every BN/ABN layer's running statistics to the per-channel mean and
    variance of its input on ``x``, in one forward pass."""
    def hook(mod, inp):
        t = inp[0].float()
        mod.running_mean.copy_(t.mean((0, 2, 3)))
        mod.running_var.copy_(t.var((0, 2, 3)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (BatchNormTorch, InPlaceABN))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(), python=sys.version.split()[0])
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    paths = kernels.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in paths:
        log = (kernels.BUILD_DIR / f"{name}.log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln or "spill" in ln][:8] \
            if log.exists() else []
    emit("build", seconds=seconds, libraries=[str(p.name) for p in paths.values()], ptxas=ptxas)


def _check(x, scale, shift, act, tol):
    got = kernels.abn_norm_act_cuda(x, scale, shift, act, SLOPE)
    want = abn_norm_act_plain(x, scale, shift, act, SLOPE)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != x.dtype or got.stride() != x.stride():
        raise AssertionError(f"abn_norm_act output {got.shape} {got.dtype} {got.stride()} "
                             f"vs input {x.shape} {x.dtype} {x.stride()}")
    err = (got.float() - want.float()).abs()
    rtol, atol = tol
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"abn_norm_act disagrees with its plain version: {x.dtype} "
                             f"{tuple(x.shape)} {act}: max err {err.max().item()}")
    return err.max().item()


def phase_kernel_b2(card: str):
    """The kernel against its plain version, then its time at the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.float32: (0.0, 1e-6), torch.bfloat16: (8e-3, 0.0)}

    def inputs(shape, dtype, layout):
        x = (torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.3).to(dtype)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        elif layout == "unaligned":  # contiguous but 2 bytes off a 16-byte boundary
            buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
            x = buf[1:].view(shape).copy_(x)
        c = shape[1]
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        shift = torch.randn(c, device="cuda", generator=g)
        return x, scale, shift

    n_cases, max_err = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("leaky_relu", "elu", "none"):
            for shape, layout in (((3, 37, 19, 23), "channels_last"), ((3, 37, 19, 23), "nchw"),
                                  ((1500, 48), "nchw"), ((2, 24, 17, 9), "unaligned")):
                err = _check(*inputs(shape, dtype, layout), act, tol[dtype])
                max_err[dtype] = max(max_err[dtype], err)
                n_cases += 1
    shapes = decoder_abn_shapes(BATCH, PATCH)
    for shape in shapes:
        err = _check(*inputs(shape, torch.bfloat16, "channels_last"), "leaky_relu", tol[torch.bfloat16])
        max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
        n_cases += 1
    big = max(shapes, key=lambda s: int(np.prod(s)))
    err = _check(*inputs(big, torch.float32, "nchw"), "leaky_relu", tol[torch.float32])
    max_err[torch.float32] = max(max_err[torch.float32], err)
    n_cases += 1

    bw, flops, rate_src = card_rates(card)

    def timing(shape):
        x, scale, shift = inputs(shape, torch.bfloat16, "channels_last")
        n, c = x.numel(), shape[1]
        nbytes = 2 * n * x.element_size() + 2 * 4 * c
        ops = 3 * n  # multiply, add, select per element
        bound_ms = max(nbytes / bw, ops / flops) * 1e3
        bound_by = "bytes" if nbytes / bw >= ops / flops else "operations"
        ms = cuda_ms(lambda: kernels.abn_norm_act_cuda(x, scale, shift, "leaky_relu", SLOPE))
        plain_ms = cuda_ms(lambda: abn_norm_act_plain(x, scale, shift, "leaky_relu", SLOPE))
        return dict(shape=list(shape), bytes=nbytes, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    per_shape = [timing(s) for s in shapes]
    largest = per_shape[shapes.index(big)]
    emit("kernel_b2", cases=n_cases, max_abs_err_fp32=max_err[torch.float32],
         max_abs_err_bf16=max_err[torch.bfloat16], tolerance={"fp32": "atol 1e-6",
                                                               "bf16": "rtol 8e-3 (one bf16 ulp)"},
         rate_source=rate_src, hbm_bytes_per_s=bw, largest=largest,
         per_forward=dict(launches=len(shapes), ms=sum(t["ms"] for t in per_shape),
                          plain_ms=sum(t["plain_ms"] for t in per_shape),
                          bound_ms=sum(t["bound_ms"] for t in per_shape),
                          bytes=sum(t["bytes"] for t in per_shape)),
         per_shape=per_shape)
    return largest, max(max_err.values())


def seeded_model(device, state_dict=None):
    model = get_model("linknet34", patch_size=PATCH, device=device, seed=SEED)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def phase_model_parity(tmpdir: Path):
    """Seeded LinkNet34, calibrated on the CPU, through save/load_snapshot;
    one fp32 forward on the card (TF32 off) against the CPU."""
    rng = np.random.default_rng(SEED)
    cpu_model = seeded_model("cpu")
    calibrate_norms(cpu_model, torch.from_numpy(rng.standard_normal((2, 3, 128, 128), np.float32) * 0.5))
    path = tmpdir / "linknet34_snapshot.pth"
    save_snapshot(str(path), cpu_model, epoch=0, loss=0.0, train_history={}, args="chip_smoke")
    state_dict, meta = load_snapshot(str(path))
    cpu_model.load_state_dict(state_dict)
    gpu_model = seeded_model("cuda", state_dict)

    x = torch.from_numpy(rng.standard_normal((2, 3, PATCH, PATCH), np.float32) * 0.5)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last)).cpu()
        launches = kernels.launch_counts()
        with torch.inference_mode():
            want = cpu_model(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    logit_err = (got - want).abs().max().item()
    prob_err = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
    ok = got.shape == (2, 1, PATCH, PATCH) and bool(torch.isfinite(got).all()) and prob_err <= 1e-3
    emit("model_parity", shape=list(got.shape), max_abs_err_logits=logit_err,
         max_abs_err_probs=prob_err, tolerance="probs atol 1e-3", logit_std=want.std().item(),
         abn_launches=launches["abn_norm_act"], snapshot_meta_epoch=meta["epoch"], ok=ok)
    if not ok or launches["abn_norm_act"] != 12:
        raise AssertionError("model_parity failed")
    return state_dict


def phase_serve(state_dict):
    model = seeded_model("cuda", state_dict)
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    rng = np.random.default_rng(SEED + 1)
    images = [rng.integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3), dtype=np.uint8)
              for _ in range(N_IMAGES + 1)]
    bf16_fn = make_predict_step(model, bf16=True)
    kw = dict(test_transform=transform, patch_size=PATCH, batch_size=BATCH, tta=True,
              weight="pyramid", device="cuda")

    t0 = time.perf_counter()
    predict_tiled(images[-1], bf16_fn, threshold=0.5, **kw)
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    masks = list(predict_tiled_stream([(i, (lambda im=im: im)) for i, im in enumerate(images[:N_IMAGES])],
                                      bf16_fn, threshold=0.5, depth=DEPTH, **kw))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_tiles = 19 * 19
    chunk = BATCH // 8
    passes = -(-n_tiles // chunk)
    for key, mask in masks:
        if mask.shape != (IMAGE_SIDE, IMAGE_SIDE) or mask.dtype != np.uint8 \
                or not set(np.unique(mask).tolist()) <= {0, 255}:
            raise AssertionError(f"serve: bad mask {key}: {mask.shape} {mask.dtype}")
    if [k for k, _ in masks] != list(range(N_IMAGES)):
        raise AssertionError("serve: masks out of order")
    expect = N_IMAGES * passes * 12
    if launches["abn_norm_act"] != expect:
        raise AssertionError(f"serve: {launches['abn_norm_act']} B2 launches, expected {expect}")

    # one model pass (64 x 3 x 512 x 512, bf16) on its own, for the share of the kernel
    x = torch.randn(BATCH, 3, PATCH, PATCH, device="cuda").contiguous(memory_format=torch.channels_last)
    pass_ms = cuda_ms(lambda: bf16_fn(x), reps=10)

    # bf16 vs fp32 (TF32 off) on a 1024^2 crop
    crop = images[0][:1024, :1024]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = predict_tiled(crop, make_predict_step(model, bf16=False), **kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    p16 = predict_tiled(crop, bf16_fn, **kw)
    agree = float(((p32 > 0.5) == (p16 > 0.5)).mean())
    prob_diff = float(np.abs(p32 - p16).max())

    # the tiled path on the card vs the CPU, fp32, at a small size
    small = rng.integers(0, 256, (150, 130, 3), dtype=np.uint8)
    cpu_model = seeded_model("cpu", state_dict)
    small_kw = dict(kw, patch_size=64, batch_size=16)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        small_gpu = predict_tiled(small, make_predict_step(model), **small_kw)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    small_cpu = predict_tiled(small, make_predict_step(cpu_model), **dict(small_kw, device="cpu"))
    small_err = float(np.abs(small_gpu - small_cpu).max())

    ok = agree >= 0.99 and small_err <= 1e-4 and np.isfinite(p16).all()
    emit("serve", s_per_image=seconds / N_IMAGES, seconds=seconds, images=N_IMAGES,
         image=[IMAGE_SIDE, IMAGE_SIDE, 3], patch=PATCH, batch=BATCH, tta=8, depth=DEPTH,
         dtype="bfloat16", tiles_per_image=n_tiles, model_passes_per_image=passes,
         abn_launches=launches["abn_norm_act"], abn_launches_per_image=launches["abn_norm_act"] // N_IMAGES,
         max_memory_allocated=peak, warm_image_s=warm_s, model_pass_ms=pass_ms,
         mask_positive_share=float(np.mean([m.mean() / 255 for _, m in masks])),
         bf16_vs_fp32_mask_agreement=agree, bf16_vs_fp32_max_prob_diff=prob_diff,
         small_card_vs_cpu_max_prob_err=small_err, small_tolerance="atol 1e-4", ok=bool(ok))
    if not ok:
        raise AssertionError("serve checks failed")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    card, smi = phase_device()
    phase_build()
    largest, max_err = phase_kernel_b2(card)
    with tempfile.TemporaryDirectory() as tmp:
        state_dict = phase_model_parity(Path(tmp))
    launches = phase_serve(state_dict)
    if launches["abn_norm_act"] == 0:
        raise AssertionError("the serving path never launched the B2 kernel")
    print(json.dumps({"kernels": [{
        "id": "B2", "name": "abn_norm_act", "checked": True, "route": "cuda",
        "source": "segtpu_torch/csrc/abn_norm_act.cu",
        "replaces": "segtpu/ops/bn_alt.py:181",
        "launches": launches["abn_norm_act"], "max_abs_err": max_err,
        "ms": largest["ms"], "plain_ms": largest["plain_ms"], "bound_ms": largest["bound_ms"],
        "bound_by": largest["bound_by"], "library_ms": None,
        "shape": largest["shape"], "dtype": "bfloat16", "layout": "channels_last",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
