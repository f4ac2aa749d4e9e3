"""Benchmarks of the port: segtpu's six configs (counterpart of bench.py).

    python -m segtpu_torch.bench --config zf_unet-512
    python -m segtpu_torch.bench --config linknet34-bce_jaccard-adam-512
    python -m segtpu_torch.bench --config unet11-finetune-512
    python -m segtpu_torch.bench --config albunet-finetune-512
    python -m segtpu_torch.bench --config tiramisu67-512-b4
    python -m segtpu_torch.bench --config inria-tiled-inference-5000
    python -m segtpu_torch.bench --all
    python -m segtpu_torch.bench [--model zf_unet] [--batch-size 16] [--patch 512] [--steps 20] [--no-s2d]
    python -m segtpu_torch.bench --measure-cpu-baseline

Each config prints one JSON line with ``bench.py``'s keys, ``{"metric",
"value", "unit", "vs_baseline"}``, plus the ``device`` it ran on and the
``form`` it ran (``"s2d"`` or ``"normal"``); ``--all`` prints the six lines.
It runs on CUDA unless given ``--device cpu``. Weights are random, drawn
from a seed.

Training (bench.py:40-96, 202-219): the five training configs time
``steps`` steps after 3 warm ones on one fixed batch: a real DSB2018 batch
when ``--data-dir`` (default ``data/dsb2018``) holds ``images/``, the first
``batch_size`` samples of the port's ``DSB2018Sliced`` train split drawn as
segtpu draws them (its host augmentations on Python's global ``random``),
else one SHAPES batch made on the device. ``zf_unet-512`` is segtpu's
default config. As segtpu does, the bench runs it and
``unet11-finetune-512`` with ``s2d=True`` unless given ``--no-s2d``: the
same function computed in space-to-depth form, which segtpu chose for the
TPU's 128-lane channel tiles (segtpu/ops/s2d.py:3-9). The two finetune
configs train with the encoder frozen (``ENCODER_PREFIXES``), and
``tiramisu67-512-b4`` times 10 steps at batch 4. ``vs_baseline`` of
``zf_unet-512`` is its images/s over ``cpu_images_per_sec`` of the
repository's ``bench_baseline.json`` (read, never written); the other
configs carry null.

Serving, ``inria-tiled-inference-5000`` (bench.py:133-197, 220-234):
:func:`measure_tiled_inference`, LinkNet34 over 5000^2 uint8 images at patch
512, tile batch 64, D4 TTA, pyramid weights, bf16, threshold 0.5, streamed
at depth 2; seconds per image, the best of 2 repeats over 4 images.

Without ``--config`` or ``--all``, the ad-hoc mode times ``--model`` at
``--batch-size`` and ``--patch`` with BCE and SGD (bench.py:293-310), in its
s2d form where the model has one unless given ``--no-s2d``.

``--measure-cpu-baseline`` times the port's own fp32 ZF_UNET on the CPU
with segtpu's recipe (batch 4, 512^2, SGD, BCE, 1 warm and 3 timed steps,
bench.py:99-130) and prints the rate; it writes no file. segtpu's
baseline in ``bench_baseline.json`` is the torch reference's ZF_UNET on the
CPU, which is not part of this repository.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from segtpu_torch.data.shapes import DeviceShapes
from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.models import get_model, without_encoder
from segtpu_torch.ops.losses import get_loss
from segtpu_torch.ops.metrics import default_metrics
from segtpu_torch.train.optim import get_optimizer
from segtpu_torch.train.state import make_predict_step, make_train_step

# segtpu's five training configs (bench.py:202-219)
BENCH_CONFIGS = {
    "zf_unet-512": dict(model_name="zf_unet", patch=512, batch_size=16, loss_name="bce",
                        optimizer="sgd", s2d=True),
    "linknet34-bce_jaccard-adam-512": dict(
        model_name="linknet34", patch=512, batch_size=16, loss_name="bce_jaccard",
        optimizer="adam"),
    "unet11-finetune-512": dict(model_name="unet11", patch=512, batch_size=16, loss_name="bce",
                                optimizer="adam", freeze_encoder=True, s2d=True),
    "albunet-finetune-512": dict(model_name="albunet", patch=512, batch_size=16,
                                 loss_name="bce", optimizer="adam", freeze_encoder=True),
    "tiramisu67-512-b4": dict(model_name="tiramisu67", patch=512, batch_size=4, steps=10,
                              loss_name="bce", optimizer="sgd"),
}
# segtpu's serving config (bench.py:133-197, 220)
TILED_CONFIG = "inria-tiled-inference-5000"
TILED = dict(patch=512, image_size=5000, batch_size=64, model_name="linknet34", bf16=True,
             n_images=4, depth=2)
CONFIG_NAMES = sorted(list(BENCH_CONFIGS) + [TILED_CONFIG])
DEFAULT_DATA_DIR = "data/dsb2018"
# the repository's bench_baseline.json (segtpu's CPU baseline of zf_unet-512)
BASELINE_PATH = Path(__file__).resolve().parent.parent / "bench_baseline.json"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def has_dsb2018(data_dir) -> bool:
    return bool(data_dir) and os.path.isdir(os.path.join(data_dir, "images"))


def dsb2018_batch(batch_size: int, patch: int, data_dir: str):
    """The first ``batch_size`` samples of the DSB2018 train split at
    ``patch`` (segtpu bench.py:20-37): NCHW float32 ``(x, y)`` on the CPU.
    The host augmentations draw from Python's global ``random``, as segtpu's
    do outside a loader."""
    from segtpu_torch.data.dsb2018 import DSB2018Sliced

    train, _, _ = DSB2018Sliced(data_dir, grayscale=False, patch_size=patch)
    samples = [train[i] for i in range(batch_size)]
    x, y = (torch.from_numpy(np.stack([s[k] for s in samples])).permute(0, 3, 1, 2).contiguous()
            for k in (0, 1))
    return x, y


def training_batch(batch_size: int, patch: int, device: torch.device, seed: int = 0,
                   data_dir: Optional[str] = None):
    """The bench's fixed batch: the DSB2018 batch when ``data_dir`` holds
    ``images/``, else one SHAPES batch made on the device. Returns
    ``(x, y, source)``, ``source`` ``"dsb2018"`` or ``"synthetic shapes"``."""
    if has_dsb2018(data_dir):
        x, y = dsb2018_batch(batch_size, patch, data_dir)
        return x.to(device), y.to(device), "dsb2018"
    gen = torch.Generator(device=device).manual_seed(seed)
    x, y = DeviceShapes(patch, device=device).batch(batch_size, gen)
    return x, y, "synthetic shapes"


def build_train_step(batch_size: int = 16, patch: int = 512, model_name: str = "linknet34",
                     bf16: bool = True, loss_name: str = "bce_jaccard", optimizer: str = "adam",
                     lr: float = 1e-3, freeze_encoder: bool = False, device: DeviceLike = None,
                     seed: int = 0, s2d: Optional[bool] = False, data_dir: Optional[str] = None,
                     **attrs):
    """The bench's training step: ``(step, x, y, model, info)``, ``step(x, y,
    lr)`` one training step of ``model_name`` with random weights from
    ``seed`` on the fixed batch ``(x, y)`` (:func:`training_batch`).
    ``freeze_encoder``: the encoder's gradients are zeroed, as under the
    train CLI's ``--freeze-encoder``; ``s2d``: the model's s2d form
    (ValueError for a model without one; None: the s2d form where the model
    has one); ``attrs`` are set on the model (``packed``, ``remat``, ...).
    ``info`` holds the ``form`` and the batch's ``source``."""
    dev = resolve_device(device)
    model = get_model(model_name, patch_size=patch, device=dev, seed=seed)
    if s2d is None:
        s2d = hasattr(model, "s2d")
    for attr, value in dict(attrs, **({"s2d": True} if s2d else {})).items():
        if not hasattr(model, attr):
            raise ValueError(f"model '{model_name}' has no {attr} mode")
        setattr(model, attr, value)
    opt = get_optimizer(optimizer, model.parameters(), lr)
    trainable = (without_encoder(model_name, (n for n, _ in model.named_parameters()))
                 if freeze_encoder else None)
    step = make_train_step(model, opt, get_loss(loss_name), default_metrics(), bf16=bf16,
                           trainable_mask=trainable)
    x, y, source = training_batch(batch_size, patch, dev, seed, data_dir)
    return step, x, y, model, dict(form="s2d" if s2d else "normal", source=source)


def measure_train(batch_size: int = 16, patch: int = 512, steps: int = 20, warmup: int = 3,
                  lr: float = 1e-3, info: Optional[dict] = None, **kwargs) -> float:
    """Images per second of ``steps`` training steps after ``warmup`` ones,
    on one fixed batch; ``kwargs`` as of :func:`build_train_step`. ``info``,
    when given, receives the ``form`` and the batch's ``source``. Raises if
    the last loss is not finite."""
    step, x, y, model, meta = build_train_step(batch_size, patch, lr=lr, **kwargs)
    dev = x.device
    if info is not None:
        info.update(meta)

    for _ in range(warmup):
        logs = step(x, y, lr)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = step(x, y, lr)
    final_loss = float(logs["loss"])
    _sync(dev)
    dt = time.perf_counter() - t0
    if final_loss != final_loss or abs(final_loss) == float("inf"):
        raise FloatingPointError(f"non-finite loss {final_loss} in the bench")
    return batch_size * steps / dt


def tiled_images(n_images: int, image_size: int):
    """segtpu's seeded serving images: ``np.random.RandomState(0)``, uint8
    HWC."""
    rng = np.random.RandomState(0)
    return [(rng.rand(image_size, image_size, 3) * 255).astype(np.uint8)
            for _ in range(n_images)]


def measure_tiled_inference(patch: int = 512, image_size: int = 5000, batch_size: int = 64,
                            model_name: str = "linknet34", bf16: bool = True, n_images: int = 4,
                            depth: int = 2, repeats: int = 2, device: DeviceLike = None,
                            seed: int = 0) -> float:
    """Seconds per image of config #5 as the submission path runs it
    (segtpu bench.py:133-197): ``model_name`` with random weights from
    ``seed``, one warm :func:`predict_tiled` with threshold 0.5, then the
    best of ``repeats`` runs of :func:`predict_tiled_stream` at ``depth``
    over ``n_images`` seeded images (D4 TTA, pyramid weights, uint8 masks
    at threshold 0.5), each run's wall time over its image count."""
    from segtpu_torch.inference import predict_tiled, predict_tiled_stream

    dev = resolve_device(device)
    model = get_model(model_name, patch_size=patch, device=dev, seed=seed)
    predict_fn = make_predict_step(model, bf16=bf16)
    images = tiled_images(n_images, image_size)
    kw = dict(patch_size=patch, batch_size=batch_size, tta=True, threshold=0.5, device=dev)
    predict_tiled(images[0], predict_fn, **kw)
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        items = [(i, (lambda im=im: im)) for i, im in enumerate(images)]
        t0 = time.perf_counter()
        n = 0
        for _key, mask in predict_tiled_stream(items, predict_fn, depth=depth, **kw):
            if mask.shape != (image_size, image_size):
                raise AssertionError(f"mask of shape {mask.shape}")
            n += 1
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def read_baseline(path=BASELINE_PATH) -> Optional[float]:
    """``cpu_images_per_sec`` of ``bench_baseline.json``, None without the file."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return float(json.load(f)["cpu_images_per_sec"])


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_config(name: str, device: DeviceLike = None, s2d: bool = True,
               data_dir: Optional[str] = None, **overrides) -> dict:
    """One config's JSON line; ``s2d=False`` runs a config whose default is
    the s2d form in normal space. ``overrides`` replace the config's
    arguments of :func:`measure_train` or :func:`measure_tiled_inference`
    (``steps``, ``warmup``; ``n_images``, ``repeats``)."""
    dev = resolve_device(device)
    if name == TILED_CONFIG:
        secs = measure_tiled_inference(device=dev, **dict(TILED, **overrides))
        return {"metric": f"{name} (linknet34@512, D4 TTA x8, pyramid merge)",
                "value": round(secs, 4),
                "unit": "sec/image" if dev.type == "cuda" else "sec/image/cpu",
                "vs_baseline": None, "device": _device_name(dev), "form": "normal"}
    config = dict(BENCH_CONFIGS[name], **overrides)
    form = "s2d" if config.pop("s2d", False) and s2d else "normal"
    value = measure_train(device=dev, s2d=form == "s2d", data_dir=data_dir, **config)
    vs_baseline = None
    if name == "zf_unet-512":
        cpu = read_baseline()
        vs_baseline = None if cpu is None else round(value / cpu, 2)
    return {
        "metric": f"{name} bf16 train throughput",
        "value": round(value, 2),
        "unit": "images/sec/gpu" if dev.type == "cuda" else "images/sec/cpu",
        "vs_baseline": vs_baseline,
        "device": _device_name(dev),
        "form": form,
    }


def measure_cpu_baseline(batch_size: int = 4, patch: int = 512, steps: int = 3,
                         seed: int = 0) -> float:
    """Images per second of the port's fp32 ZF_UNET training on the CPU,
    with segtpu's recipe (bench.py:99-130): SGD lr 1e-3, BCE with logits
    scaled by the batch, one warm step, then ``steps`` timed ones."""
    torch.set_num_threads(os.cpu_count() or 8)
    model = get_model("zf_unet", patch_size=patch, device="cpu", seed=seed)
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    lossf = torch.nn.BCEWithLogitsLoss()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch_size, 3, patch, patch, generator=g)
    y = (torch.rand(batch_size, 1, patch, patch, generator=g) > 0.5).float()

    def step():
        opt.zero_grad()
        (batch_size * lossf(model(x), y)).backward()
        opt.step()

    step()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    return batch_size * steps / (time.perf_counter() - t0)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default=None, choices=CONFIG_NAMES,
                        help="run one of segtpu's six configs")
    parser.add_argument("--all", action="store_true", help="run all six configs, a line each")
    parser.add_argument("--measure-cpu-baseline", action="store_true",
                        help="time the port's fp32 ZF_UNET on the CPU and print the rate")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    parser.add_argument("--no-s2d", action="store_true",
                        help="run zf_unet-512 and unet11-finetune-512 (and an ad-hoc model) in "
                             "normal space instead of their default s2d form (the same math)")
    parser.add_argument("--data-dir", default=DEFAULT_DATA_DIR,
                        help="DSB2018 root (images/ + masks/) of the training batch; the "
                             "synthetic shapes batch when it is absent")
    parser.add_argument("--model", default="zf_unet", help="ad-hoc mode: the model")
    parser.add_argument("--batch-size", type=int, default=16, help="ad-hoc mode: the batch")
    parser.add_argument("--patch", type=int, default=512, help="ad-hoc mode: the patch")
    parser.add_argument("--steps", type=int, default=20, help="ad-hoc mode: timed steps")
    args = parser.parse_args(argv)

    if args.measure_cpu_baseline:
        ips = measure_cpu_baseline(patch=args.patch)
        print(json.dumps({"cpu_images_per_sec": ips, "patch": args.patch, "model": "zf_unet",
                          "note": "segtpu_torch fp32 ZF_UNET on the CPU"}), flush=True)
        return
    if args.all or args.config:
        for name in (CONFIG_NAMES if args.all else [args.config]):
            print(json.dumps(run_config(name, device=args.device, s2d=not args.no_s2d,
                                        data_dir=args.data_dir)), flush=True)
        return

    dev, info = resolve_device(args.device), {}
    value = measure_train(batch_size=args.batch_size, patch=args.patch, steps=args.steps,
                          model_name=args.model, loss_name="bce", optimizer="sgd", device=dev,
                          s2d=False if args.no_s2d else None, data_dir=args.data_dir, info=info)
    cpu = read_baseline()
    # segtpu's baseline is zf_unet at its patch; another model has none
    vs_baseline = (round(value / cpu, 2) if cpu is not None and args.model == "zf_unet"
                   and args.patch == 512 else None)
    print(json.dumps({
        "metric": f"{args.model} {args.patch}^2 bf16 train throughput ({info['source']})",
        "value": round(value, 2),
        "unit": "images/sec/gpu" if dev.type == "cuda" else "images/sec/cpu",
        "vs_baseline": vs_baseline,
        "device": _device_name(dev),
        "form": info["form"],
    }), flush=True)


if __name__ == "__main__":
    main()
