"""Lower bound of config #5, INRIA-scale tiled inference, on one GPU
(counterpart of segtpu's tools/tiled_floor.py).

    python -m segtpu_torch.tiled_floor [--patch 512] [--size 5000] [--batch 64] [--model linknet34]

One 5000^2 image at patch 512, step 256, D4 TTA x8, tile batch 64:

  * model passes: the image needs 361 tiles x 8 TTA = 2888 passes; the
    sweep executes 46 chunks of 8 tiles x 8 TTA = 2944, the last chunk
    padded with copies of the first tile, which the bound does not count;
  * FLOPs: each pass's model FLOPs from ``roofline.forward_flops``
    (``FlopCounterMode`` over one eval forward of one tile), times 2888;
  * merge bytes, from shapes: the TTA average reads the 8 fp32 outputs of
    each tile and writes one, the merge reads each tile once and writes the
    uint8 mask;
  * device bound: ``max(FLOPs / 989 TFLOP/s, merge bytes / 3.35 TB/s)``
    (NVIDIA's data sheet, H100 SXM dense bf16 at 700 W; ``--peak-tflops`` for
    another card);
  * transfers: the uint8 canvas (the padded image, 5120^2 x 3 = 78.6 MB) up
    and the uint8 mask (25 MB) down, timed between pinned host buffers and
    the card, best of 3 each.

``predict_tiled_stream`` at depth 2 overlaps the host's preparation and
upload of image i+1 and the fetch of image i-1 with the sweep of image i, so
the floor per image is ``max(device bound, transfers)``, not their sum. It
is printed beside the measured s/image of ``bench.measure_tiled_inference``
(config #5's recipe; ``--no-measure`` skips it).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import torch

from segtpu_torch.device import DeviceLike, card_line, resolve_device
from segtpu_torch.tiles import ImageSlicer

TTA = 8
FP32, UINT8 = 4, 1


def geometry(image_size: int = 5000, patch: int = 512, batch: int = 64) -> dict:
    """Tiles, chunks and model passes of one ``image_size``^2 image, as the
    port's tiled path cuts it (``ImageSlicer`` at step ``patch // 2``)."""
    slicer = ImageSlicer((image_size, image_size, 3), patch, patch // 2)
    n_tiles = len(slicer.crops)
    chunk = max(1, batch // TTA)
    n_chunks = math.ceil(n_tiles / chunk)
    canvas = slicer.target_shape
    return dict(tiles=n_tiles, chunk=chunk, chunks=n_chunks, passes_needed=n_tiles * TTA,
                passes_executed=n_chunks * chunk * TTA, canvas=[canvas[0], canvas[1], 3],
                image=[image_size, image_size])


def merge_bytes(geom: dict, patch: int) -> int:
    """Bytes of the TTA average and the merge (module docstring)."""
    tile = patch * patch * FP32
    tta = geom["passes_needed"] * tile + geom["tiles"] * tile
    merge = geom["tiles"] * tile + geom["image"][0] * geom["image"][1] * UINT8
    return tta + merge


def transfer_seconds(nbytes: int, device: torch.device, reps: int = 3):
    """``(up, down)``: the best of ``reps`` timed copies of ``nbytes`` of
    uint8 from a pinned host buffer to ``device`` and back."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    up, down = [], []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dev.copy_(host, non_blocking=True)
        torch.cuda.synchronize(device)
        up.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        host.copy_(dev, non_blocking=True)
        torch.cuda.synchronize(device)
        down.append(time.perf_counter() - t0)
    return min(up), min(down)


def analyze(patch: int = 512, image_size: int = 5000, batch: int = 64,
            model_name: str = "linknet34", device: DeviceLike = None,
            peak_tflops: Optional[float] = None, peak_hbm_gbs: Optional[float] = None,
            measured_s_per_image: Optional[float] = None) -> dict:
    """The bound of the module docstring on the card (or on the CPU with
    given peaks and no transfers), beside ``measured_s_per_image``."""
    from segtpu_torch.roofline import card_peaks, forward_flops

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak, hbm, source = card_peaks(name, peak_tflops, peak_hbm_gbs)
    if hbm is None:
        raise SystemExit(f"tiled_floor: no known HBM rate for '{name}'; pass --peak-hbm-gbs")
    geom = geometry(image_size, patch, batch)
    pass_flops = forward_flops(model_name, patch, dev)
    flops = geom["passes_needed"] * pass_flops
    mbytes = merge_bytes(geom, patch)
    t_flop, t_hbm = flops / peak, mbytes / hbm
    up_bytes = geom["canvas"][0] * geom["canvas"][1] * 3
    down_bytes = image_size * image_size
    if dev.type == "cuda":
        t_up = transfer_seconds(up_bytes, dev)[0]
        t_down = transfer_seconds(down_bytes, dev)[1]
    else:
        t_up = t_down = None
    t_transfer = None if t_up is None else t_up + t_down
    t_device = max(t_flop, t_hbm)
    floor = t_device if t_transfer is None else max(t_device, t_transfer)
    return dict(
        geom, model=model_name, patch=patch, batch=batch, gflop_per_pass=pass_flops / 1e9,
        tflop_per_image=flops / 1e12, merge_gb=mbytes / 1e9, peak_tflops=peak / 1e12,
        peak_hbm_gbs=hbm / 1e9, peak_source=source, t_flop_bound_s=t_flop,
        t_hbm_bound_s=t_hbm, t_device_bound_s=t_device,
        bound_by="operations" if t_flop >= t_hbm else "bytes",
        up_mb=up_bytes / 1e6, down_mb=down_bytes / 1e6, t_up_s=t_up, t_down_s=t_down,
        t_transfer_s=t_transfer, floor_s_per_image=floor,
        measured_s_per_image=measured_s_per_image,
        floor_share_of_measured=None if measured_s_per_image is None
        else floor / measured_s_per_image,
        card=card_line() if dev.type == "cuda" else "cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--patch", type=int, default=512)
    p.add_argument("--size", type=int, default=5000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--model", default="linknet34")
    p.add_argument("--peak-tflops", type=float, default=None)
    p.add_argument("--peak-hbm-gbs", type=float, default=None)
    p.add_argument("--no-measure", action="store_true", help="print the bound only")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' needs --peak-tflops and "
                        "--peak-hbm-gbs and times no transfer)")
    args = p.parse_args(argv)
    measured = None
    if not args.no_measure:
        from segtpu_torch.bench import measure_tiled_inference

        measured = measure_tiled_inference(patch=args.patch, image_size=args.size,
                                           batch_size=args.batch, model_name=args.model,
                                           device=args.device)
    print(json.dumps(analyze(args.patch, args.size, args.batch, args.model, args.device,
                             args.peak_tflops, args.peak_hbm_gbs, measured)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
