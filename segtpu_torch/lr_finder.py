"""LR range finder (counterpart of segtpu/lr_finder.py and segtpu's root
``test.py``; reference lib/train_utils.py:36-69 and test.py:8-32).

An exponential sweep 1e-8 * 2^i over 30 steps: one optimizer step at each
learning rate through the port's train step, recording the loss; the
command line (:func:`main`) smooths the losses with a 4-tap box filter
and plots them against the learning rate on a log axis. The losses stay
on the device until the sweep ends and are fetched once.

    python -m segtpu_torch.lr_finder -m linknet34 -d shapes-device -l bce -o sgd \\
        -b 4 -p 128 --out loss_plot.png

Runs on CUDA unless ``--device cpu``. matplotlib is imported only to plot;
without it the curve is drawn into a plain PNG.
"""

from __future__ import annotations

import argparse
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from segtpu_torch.data.pipeline import prefetch_to_device
from segtpu_torch.device import DeviceLike
from segtpu_torch.train.optim import lr_finder_schedule
from segtpu_torch.train.state import make_train_step


def find_optimal_lr(model: nn.Module, optimizer: torch.optim.Optimizer, loss_fn: Callable,
                    dataloader, n_steps: int = 30, min_lr: float = 1e-8,
                    device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """``(lrs, losses)``: one step of ``model`` at each learning rate of the
    sweep, the loader restarted when it runs out (reference
    find_optimal_lr). ``lrs`` are float32, as segtpu's."""
    lrs = np.array(lr_finder_schedule(n_steps, min_lr), dtype=np.float32)
    step = make_train_step(model, optimizer, loss_fn)

    def batches():
        while True:
            yield from prefetch_to_device(dataloader, device)

    device_losses = []
    for lr, batch in zip(lrs, batches()):
        device_losses.append(step(batch[0], batch[1], float(lr))["loss"])
    losses = torch.stack(device_losses).float().cpu().numpy()
    return lrs, losses


def smooth_losses(losses: np.ndarray, taps: int = 4) -> np.ndarray:
    """4-tap box smoothing (reference test.py:21-24)."""
    kernel = np.ones(taps) / taps
    return np.convolve(losses, kernel, mode="valid")


def _write_png(path: str, rgb: np.ndarray) -> None:
    """An [H, W, 3] uint8 image as an 8-bit RGB PNG, with the standard
    library's zlib."""
    import struct
    import zlib

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    rows = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def _raster_plot(x: np.ndarray, y: np.ndarray, out: str) -> None:
    """The curve ``y`` against ``x`` (log x) drawn into a plain 800 x 500 PNG
    with its axes, for a host without matplotlib."""
    h, w, margin = 500, 800, 40
    img = np.full((h, w, 3), 255, np.uint8)
    img[h - margin, margin:w - margin] = 0
    img[margin:h - margin, margin] = 0
    lx = np.log10(x)
    finite = np.isfinite(y)
    if finite.sum() >= 2:
        lo, hi = float(np.min(y[finite])), float(np.max(y[finite]))
        u = margin + (lx - lx.min()) / max(lx.max() - lx.min(), 1e-12) * (w - 2 * margin - 1)
        v = h - margin - (y - lo) / max(hi - lo, 1e-12) * (h - 2 * margin - 1)
        for i in range(len(u) - 1):
            if finite[i] and finite[i + 1]:
                t = np.linspace(0.0, 1.0, 200)
                cols = np.round(u[i] + t * (u[i + 1] - u[i])).astype(int)
                rows = np.round(v[i] + t * (v[i + 1] - v[i])).astype(int)
                img[rows, cols] = (31, 119, 180)
    _write_png(out, img)


def plot_losses(lrs: np.ndarray, losses: np.ndarray, out: str) -> None:
    """The smoothed loss against the learning rate, log x, saved to ``out``
    (a PNG): through matplotlib where it is installed, else drawn by
    :func:`_raster_plot`."""
    smoothed = smooth_losses(losses)
    try:
        import matplotlib
    except ImportError:
        _raster_plot(lrs[: len(smoothed)], smoothed, out)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 5))
    plt.semilogx(lrs[: len(smoothed)], smoothed)
    plt.xlabel("learning rate")
    plt.ylabel("loss (smoothed)")
    plt.grid(True, which="both", alpha=0.3)
    fig.savefig(out, dpi=120)
    plt.close(fig)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LR range finder")
    parser.add_argument("-g", "--grayscale", action="store_true")
    parser.add_argument("-m", "--model", required=True, type=str)
    parser.add_argument("-p", "--patch-size", type=int, default=224)
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("-l", "--loss", type=str, default="bce")
    parser.add_argument("-o", "--optimizer", default="SGD")
    parser.add_argument("-d", "--dataset", type=str, required=True)
    parser.add_argument("-dd", "--data-dir", type=str, default="data")
    parser.add_argument("-w", "--workers", default=4, type=int)
    parser.add_argument("-mem", "--memory", action="store_true")
    parser.add_argument("--out", type=str, default="loss_plot.png")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default cuda; a missing GPU is an error)")
    return parser


def main(argv=None) -> Tuple[np.ndarray, np.ndarray]:
    """segtpu's ``test.py``: build the model, sweep, print and plot."""
    args = build_arg_parser().parse_args(argv)

    from segtpu_torch.data import get_dataset
    from segtpu_torch.data.pipeline import DataLoader
    from segtpu_torch.data.shapes import DeviceShapesSet
    from segtpu_torch.device import resolve_device
    from segtpu_torch.models import get_model
    from segtpu_torch.ops.losses import get_loss
    from segtpu_torch.train.optim import get_optimizer

    device = resolve_device(args.device)
    trainset, _, _ = get_dataset(args.dataset, args.data_dir, grayscale=args.grayscale,
                                 patch_size=args.patch_size, keep_in_mem=args.memory)
    num_channels = getattr(trainset, "num_channels", None)
    if num_channels is None:
        num_channels = 1 if args.grayscale else 3
    model = get_model(args.model, patch_size=args.patch_size, num_channels=num_channels,
                      device=device)
    optimizer = get_optimizer(args.optimizer, model.parameters(), 1e-8)
    if isinstance(trainset, DeviceShapesSet):
        loader = trainset.loader(args.batch_size, device)
    else:
        loader = DataLoader(trainset, batch_size=args.batch_size, shuffle=True,
                            workers=args.workers)

    lrs, losses = find_optimal_lr(model, optimizer, get_loss(args.loss), loader, device=device)
    print("lrs   ", lrs)
    print("losses", losses)
    plot_losses(lrs, losses, args.out)
    print("saved", args.out)
    return lrs, losses


if __name__ == "__main__":
    main()
