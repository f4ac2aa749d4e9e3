"""Tiled-inference / submission CLI of the port (counterpart of
segtpu/submit_cli.py; reference inria_submit.py:260-308).

Loads a reference-format ``.pth`` checkpoint or segtpu's own ``.ckpt``
directory (``state.msgpack`` + ``meta.json``), optionally after
torchvision-format encoder weights (``--encoder-weights``), runs full or
tiled prediction with D4 TTA over every image in ``<data-dir>/images``,
thresholds at 0.5 and writes ``.tif`` masks to ``<submits-dir>/<experiment>/``:

    python -m segtpu_torch.submit_cli -m linknet34 -c linknet34_checkpoint.pth \\
        -p 512 -b 64 -dd data/inria --bf16

``--tile-parallel`` under ``torchrun`` splits each chunk of tiles over the
ranks (:mod:`segtpu_torch.inference`); rank 0 writes the masks. Alone it is
the one-process path.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch.distributed as dist

from segtpu_torch.augment import host as aug
from segtpu_torch.compat.encoder_weights import install_encoder_weights
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.inference import predict_full, predict_tiled_stream
from segtpu_torch.models import get_model
from segtpu_torch.parallel import Grid, make_grid
from segtpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device
from segtpu_torch.train.checkpoint import load_flax_snapshot, load_snapshot
from segtpu_torch.train.state import make_predict_step
from segtpu_torch.utils import auto_file, find_in_dir, read_rgb


def build_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-g", "--grayscale", action="store_true",
                        help="Whether to use grayscale image instead of RGB")
    parser.add_argument("-m", "--model", required=True, type=str,
                        help="Name of the model")
    parser.add_argument("-c", "--checkpoint", required=True, type=str,
                        help="Reference-format .pth checkpoint of the model, or segtpu's "
                             ".ckpt snapshot directory")
    parser.add_argument("--encoder-weights", type=str, default=None,
                        help="Local torchvision-format .pth of the encoder's weights, "
                             "loaded before the checkpoint")
    parser.add_argument("-p", "--patch-size", type=int, default=224)
    parser.add_argument("-b", "--batch-size", type=int, default=1,
                        help="Batch size during inference, in model passes: "
                             "with TTA each chunk holds batch/8 tiles")
    parser.add_argument("-dd", "--data-dir", type=str, default="data",
                        help="Root directory where datasets are located.")
    parser.add_argument("-x", "--experiment", type=str,
                        help="Name of the experiment")
    parser.add_argument("-f", "--full", action="store_true")
    parser.add_argument("--no-tta", action="store_true")
    parser.add_argument("--submits-dir", type=str, default="submits")
    parser.add_argument("--tile-parallel", action="store_true",
                        help="Split each chunk of tiles over the ranks of a torchrun "
                             "launch (one rank: the one-process path)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 model compute for inference")
    parser.add_argument("--s2d", action="store_true",
                        help="Space-to-depth execution of the full-resolution level for models "
                             "that have it (the same math; segtpu_torch.ops.s2d)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; pass cpu to run "
                             "on the CPU)")
    return parser


def _write_tif(path: str, mask: np.ndarray) -> None:
    import cv2

    if not cv2.imwrite(path, mask):
        raise IOError(f"cannot write {path}")


def load_checkpoint(model, model_name: str, path: str):
    """Load a ``.pth`` or segtpu ``.ckpt`` directory into ``model``; returns
    its meta (``epoch``, ``loss``, ...)."""
    if os.path.isdir(path):
        state_dict, meta = load_flax_snapshot(path, model_name)
    else:
        state_dict, meta = load_snapshot(path)
    model.load_state_dict(state_dict)
    return meta


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    owns_group = not dist.is_initialized()
    distributed = args.tile_parallel and maybe_initialize_distributed(args.device)
    device = rank_device(args.device)
    grid = make_grid() if args.tile_parallel else Grid()

    if args.experiment is None:
        args.experiment = "inria_%s_%d_%s" % (
            args.model, args.patch_size, "gray" if args.grayscale else "rgb"
        )
    experiment_dir = os.path.join(args.submits_dir, args.experiment)
    os.makedirs(experiment_dir, exist_ok=True)

    num_channels = 1 if args.grayscale else 3
    model = get_model(args.model, patch_size=args.patch_size,
                      num_channels=num_channels, device=device)
    if args.s2d:
        if not hasattr(model, "s2d"):
            raise SystemExit(f"--s2d: model '{args.model}' has no s2d mode")
        model.s2d = True
    if args.encoder_weights:
        install_encoder_weights(args.model, model, args.encoder_weights)
    meta = load_checkpoint(model, args.model, auto_file(args.checkpoint))
    if grid.is_main:
        print("Using checkpoint from epoch", meta.get("epoch"), meta.get("loss"))

    test_transform = aug.Sequential([
        aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD)),
    ])
    predict_fn = make_predict_step(model, bf16=args.bf16)

    def base(fname):
        return os.path.splitext(os.path.basename(fname))[0]

    images = sorted(find_in_dir(os.path.join(args.data_dir, "images")))
    if args.full:
        for fname in images if grid.is_main else ():
            mask = predict_full(read_rgb(fname), predict_fn, test_transform,
                                tta=not args.no_tta, device=device)
            mask = ((mask > 0.5) * 255).astype(np.uint8)
            _write_tif(os.path.join(experiment_dir, base(fname) + ".tif"), mask)
        _finish(distributed and owns_group)
        return

    # read/decode/pad of image i+1 and the tif write of image i-1 overlap the
    # device sweep of image i
    items = [(base(f), (lambda f=f: read_rgb(f))) for f in images]
    with ThreadPoolExecutor(max_workers=2) as writer:
        writes = []
        stream = predict_tiled_stream(
            items, predict_fn, test_transform, args.patch_size, args.batch_size,
            tta=not args.no_tta, threshold=0.5, device=device, grid=grid)
        for i, (basename, mask) in enumerate(stream):
            if not grid.is_main:
                continue
            writes.append(writer.submit(
                _write_tif, os.path.join(experiment_dir, basename + ".tif"), mask))
            print(f"{i + 1}/{len(images)} {basename}", flush=True)
        for w in writes:
            w.result()  # surface IO errors
    _finish(distributed and owns_group)


def _finish(owned_group: bool) -> None:
    if owned_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
