"""Training throughput of the port (counterpart of bench.py:40-96, 200-248).

    python -m segtpu_torch.bench --config zf_unet-512
    python -m segtpu_torch.bench --config linknet34-bce_jaccard-adam-512
    python -m segtpu_torch.bench --config unet11-finetune-512
    python -m segtpu_torch.bench --config albunet-finetune-512
    python -m segtpu_torch.bench --config tiramisu67-512-b4
    python -m segtpu_torch.bench --config zf_unet-512 --no-s2d

prints one JSON line with ``bench.py``'s keys, ``{"metric", "value", "unit",
"vs_baseline"}`` (``vs_baseline`` is null: the port keeps no baseline),
plus the ``device`` it ran on and the ``form`` it ran (``"s2d"`` or
``"normal"``). It runs on CUDA unless given
``--device cpu``. Weights are random, drawn from a seed; the batch is one
fixed SHAPES batch made on the device (segtpu's default when no DSB2018
directory is present).

The configs are segtpu's five training configs (bench.py:202-219).
``zf_unet-512`` is segtpu's default config. As segtpu does, the bench runs
it and ``unet11-finetune-512`` with ``s2d=True`` unless given ``--no-s2d``:
the same function computed in space-to-depth form, which segtpu chose for
the TPU's 128-lane channel tiles (segtpu/ops/s2d.py:3-9); ``--no-s2d`` runs
them in normal space. The two finetune configs train with the encoder frozen (``ENCODER_PREFIXES``), and
``tiramisu67-512-b4`` times 10 steps at batch 4.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from segtpu_torch.data.shapes import DeviceShapes
from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.models import get_model, without_encoder
from segtpu_torch.ops.losses import get_loss
from segtpu_torch.ops.metrics import default_metrics
from segtpu_torch.train.optim import get_optimizer
from segtpu_torch.train.state import make_train_step

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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_train(batch_size: int = 16, patch: int = 512, steps: int = 20, warmup: int = 3,
                  model_name: str = "linknet34", bf16: bool = True,
                  loss_name: str = "bce_jaccard", optimizer: str = "adam",
                  lr: float = 1e-3, freeze_encoder: bool = False, device: DeviceLike = None,
                  seed: int = 0, s2d: bool = False) -> float:
    """Images per second of ``steps`` training steps after ``warmup`` ones,
    on one fixed batch. ``freeze_encoder``: the encoder's gradients are
    zeroed, as under the train CLI's ``--freeze-encoder``; ``s2d``: the
    model's s2d form (ValueError for a model without one). Raises if the
    last loss is not finite."""
    dev = resolve_device(device)
    model = get_model(model_name, patch_size=patch, device=dev, seed=seed)
    if s2d:
        if not hasattr(model, "s2d"):
            raise ValueError(f"model '{model_name}' has no s2d mode")
        model.s2d = True
    opt = get_optimizer(optimizer, model.parameters(), lr)
    trainable = (without_encoder(model_name, (n for n, _ in model.named_parameters()))
                 if freeze_encoder else None)
    step = make_train_step(model, opt, get_loss(loss_name), default_metrics(), bf16=bf16,
                           trainable_mask=trainable)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, y = DeviceShapes(patch, device=dev).batch(batch_size, gen)

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


def run_config(name: str, device: DeviceLike = None, s2d: bool = True) -> dict:
    """One config's JSON line; ``s2d=False`` runs a config whose default is
    the s2d form in normal space."""
    dev = resolve_device(device)
    config = dict(BENCH_CONFIGS[name])
    form = "s2d" if config.pop("s2d", False) and s2d else "normal"
    value = measure_train(device=dev, s2d=form == "s2d", **config)
    return {
        "metric": f"{name} bf16 train throughput",
        "value": round(value, 2),
        "unit": "images/sec/gpu" if dev.type == "cuda" else "images/sec/cpu",
        "vs_baseline": None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "form": form,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True, choices=sorted(BENCH_CONFIGS))
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run on the CPU)")
    parser.add_argument("--no-s2d", action="store_true",
                        help="run zf_unet-512 and unet11-finetune-512 in normal space instead "
                             "of their default s2d form (the same math)")
    args = parser.parse_args(argv)
    print(json.dumps(run_config(args.config, device=args.device, s2d=not args.no_s2d)),
          flush=True)


if __name__ == "__main__":
    main()
