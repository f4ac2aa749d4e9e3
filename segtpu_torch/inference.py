"""Whole-image and tiled prediction (counterpart of segtpu/inference.py;
reference inria_submit.py:217-257).

The image is uploaded once, as uint8 when the test transform is the affine
``NormalizeImage`` (4x fewer bytes than float32); the cast and the affine
run on the device. Tiles are gathered on the device in chunks of
``batch_size // 8`` tiles, each expanded x8 by D4 TTA, run through the
model, inverted and averaged; the pyramid-weighted merge and the threshold
run on the device too, and only the mask comes back.

``predict_fn(x: (N, C, H, W)) -> (N, 1, H, W)`` sigmoid probabilities on
the device of ``x`` — typically :func:`segtpu_torch.train.state.make_predict_step`.

``slice_on_device=False`` (segtpu/inference.py:142-287): the host cuts the
tiles with the native extractor (:meth:`ImageSlicer.split_batch`, in the
producer thread of the stream) and uploads each chunk's tiles, in their
upload dtype, in place of the image; the affine, the sweep and the merge
are the device path's, so the probabilities are the same.

The stream's stages are spans of :mod:`segtpu_torch.spans`, keyed by the
item's key: ``segtpu_torch.stream.prepare`` (the producer thread),
``.wait``, ``.upload``, ``.sweep``, ``.merge`` and ``.fetch`` (the
consumer); :func:`predict_tiled` records the three of the device half.

Tile-parallel (``grid`` with a data axis of N ranks; segtpu/inference.py:159-215,
351-365): each chunk is rounded up to a multiple of N tiles and rank r runs
the r-th N-th of every chunk; each rank folds its weighted tiles into the
canvas, one all-reduce adds the ranks' canvases, and every rank divides by
the weights; the caller's rank 0 thresholds and writes. Without a grid, or
with one rank, it is the one-process path.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from segtpu_torch import spans
from segtpu_torch.augment import (
    host as aug,
    pad_to_multiple,
    tta_d4_aug_batch,
    tta_d4_deaug_batch,
    unpad,
)
from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.parallel import Grid, all_reduce_
from segtpu_torch.tiles import ImageSlicer


def _device_affine(test_transform):
    """(scale, mean, std) when ``test_transform`` is an affine image-only
    normalize chain (the submit CLI's ``Normalize(INRIA stats)``), or the
    identity for None/empty; None when the chain has other parts, which then
    run on the host."""
    if test_transform is None:
        chain = []
    elif isinstance(test_transform, aug.Sequential):
        chain = list(test_transform.transforms)
    else:
        chain = [test_transform]

    scale, mean, std = np.float32(1.0), np.float32(0.0), np.float32(1.0)
    seen = False
    for part in chain:
        if isinstance(part, aug.MaskOnly):
            continue  # no mask at inference time
        inner = part.trans if isinstance(part, aug.ImageOnly) else part
        if isinstance(inner, aug.NormalizeImage) and not seen:
            scale = np.float32(inner.scale)
            mean = np.asarray(inner.mean, np.float32)
            std = np.asarray(inner.std, np.float32)
            seen = True
            continue
        return None
    return scale, mean, std


def _host_image(image: np.ndarray, test_transform):
    """(HWC image in its upload dtype, affine or None): uint8 stays uint8 when
    the affine runs on the device, anything else goes up as float32."""
    affine = _device_affine(test_transform)
    if affine is None and test_transform is not None:
        image, _ = test_transform(image, None)
    image = np.asarray(image)
    if affine is None or image.dtype != np.uint8:
        image = image.astype(np.float32, copy=False)
    if image.ndim == 2:
        image = image[..., None]
    return image, affine


def _upload(image: np.ndarray, affine, device: torch.device) -> torch.Tensor:
    """HWC host array -> (C, H, W) float32 on ``device``, with
    ``(x * scale - mean) / std`` applied there in the host transform's op
    order."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(2, 0, 1).float()
    if affine is None:
        return x.contiguous()
    scale, mean, std = affine
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device).view(-1, 1, 1)
    std = torch.as_tensor(std, dtype=torch.float32, device=device).view(-1, 1, 1)
    return (x * float(scale) - mean) / std


def predict_full(image: np.ndarray, predict_fn: Callable, test_transform=None,
                 pad_size: int = 32, tta: bool = True, device: DeviceLike = None) -> np.ndarray:
    """Whole-image prediction: pad to /32, D4 TTA, average
    (reference predict_full, inria_submit.py:217-234). Returns HW float32."""
    dev = resolve_device(device)
    image, affine = _host_image(image, test_transform)
    padded, pads = pad_to_multiple(image, pad_size)
    if tta and padded.shape[0] != padded.shape[1]:
        # batched D4 TTA needs a square canvas (rot90 views share one shape);
        # replicate-pad the short side up and fold the extra into `pads`
        side = max(padded.shape[0], padded.shape[1])
        eh, ew = side - padded.shape[0], side - padded.shape[1]
        padded = np.pad(padded, [(0, eh), (0, ew), (0, 0)], mode="edge")
        pads = (pads[0], pads[1] + eh, pads[2], pads[3] + ew)
    x = _upload(padded, affine, dev)[None]
    if tta:
        x = tta_d4_aug_batch(x)
    y = predict_fn(x)
    if tta:
        y = tta_d4_deaug_batch(y)
    return unpad(y[0, 0].float().cpu().numpy(), pads)


class _Prepared:
    """Host half of one tiled prediction: the padded image, the slicer and
    the crop origins of every chunk (the tail repeats crop 0; its result is
    dropped before the merge); with ``slice_on_device=False`` the tiles
    themselves, ``(T, p, p, C)``, in place of the padded image."""

    def __init__(self, image: np.ndarray, test_transform, patch_size: int,
                 batch_size: int, tta: bool, weight: str, n_ranks: int = 1,
                 slice_on_device: bool = True):
        image, self.affine = _host_image(image, test_transform)
        self.slicer = ImageSlicer(image.shape, patch_size, patch_size // 2, weight=weight)
        self.padded = self.slicer.pad(image) if slice_on_device else None
        self.tiles = None if slice_on_device else self.slicer.split_batch(image)
        self.n_tiles = len(self.slicer.crops)
        self.chunk = max(1, batch_size // 8) if tta else batch_size
        # tile-parallel: a whole number of tiles per rank in every chunk
        self.chunk = max(self.chunk, n_ranks)
        self.chunk += (-self.chunk) % n_ranks
        self.n_chunks = -(-self.n_tiles // self.chunk)
        pad = self.n_chunks * self.chunk - self.n_tiles
        crops = self.slicer.crops + [self.slicer.crops[0]] * pad
        self.ys = np.asarray([c[1] for c in crops], np.int64)
        self.xs = np.asarray([c[0] for c in crops], np.int64)


def _gather_tiles(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, patch: int) -> torch.Tensor:
    """(C, H, W) image, crop origins [N] -> (N, C, patch, patch) tiles, one
    indexing gather on the image's device."""
    r = torch.arange(patch, device=image.device)
    rows = (ys[:, None] + r)[:, :, None]  # (N, p, 1)
    cols = (xs[:, None] + r)[:, None, :]  # (N, 1, p)
    return image[:, rows, cols].transpose(0, 1)


def _upload_tiles(tiles: np.ndarray, affine, device: torch.device) -> torch.Tensor:
    """Host tiles ``(N, p, p, C)`` -> ``(N, C, p, p)`` float32 on ``device``,
    the affine applied there as :func:`_upload` applies it."""
    x = torch.from_numpy(np.ascontiguousarray(tiles)).to(device).permute(0, 3, 1, 2).float()
    if affine is None:
        return x
    scale, mean, std = affine
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device).view(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=torch.float32, device=device).view(1, -1, 1, 1)
    return (x * float(scale) - mean) / std


def _dispatch(prep: _Prepared, predict_fn: Callable, tta: bool, threshold: Optional[float],
              device: torch.device, grid: Optional[Grid] = None, key=None) -> torch.Tensor:
    """Device half: upload, chunked sweep (this rank's share of each chunk
    under a grid), merge and threshold. Returns the (H, W) mask on the
    device without waiting for it. ``key``: the item's key on its spans."""
    n, rank = (grid.data_size, grid.data_rank) if grid is not None else (1, 0)
    patch = prep.slicer.tile_size
    share = prep.chunk // n
    with spans.span("segtpu_torch.stream.upload", key):
        if prep.tiles is None:
            image = _upload(prep.padded, prep.affine, device)
            ys = torch.from_numpy(prep.ys).to(device)
            xs = torch.from_numpy(prep.xs).to(device)
        else:
            # the tail repeats tile 0, as the device path repeats crop 0
            index = np.arange(prep.n_chunks * prep.chunk)
            index[prep.n_tiles:] = 0
    with spans.span("segtpu_torch.stream.sweep", key):
        preds = []
        for i in range(prep.n_chunks):
            sl = slice(i * prep.chunk + rank * share, i * prep.chunk + (rank + 1) * share)
            if prep.tiles is None:
                x = _gather_tiles(image, ys[sl], xs[sl], patch)
            else:
                x = _upload_tiles(prep.tiles[index[sl]], prep.affine, device)
            if tta:
                x = tta_d4_aug_batch(x)
            y = predict_fn(x)
            preds.append(tta_d4_deaug_batch(y) if tta else y)
        preds = torch.cat(preds)
    with spans.span("segtpu_torch.stream.merge", key):
        reduce_fn = None
        if n > 1:
            # this rank's tiles in their places, zeros in the others' (their
            # weighted sums come through the all-reduce)
            tail = preds.shape[1:]
            full = preds.new_zeros((prep.n_chunks, n, share) + tail)
            full[:, rank] = preds.view((prep.n_chunks, share) + tail)
            preds = full.view((-1,) + tail)
            reduce_fn = lambda acc: all_reduce_([acc], grid.data_group)  # noqa: E731
        merged = prep.slicer.merge_device(preds[:prep.n_tiles], reduce_fn)[0]
        if threshold is not None:
            return (merged > threshold).to(torch.uint8) * 255
        return merged


def _ranks(grid: Optional[Grid]) -> int:
    return 1 if grid is None else grid.data_size


def predict_tiled(image: np.ndarray, predict_fn: Callable, test_transform=None,
                  patch_size: int = 224, batch_size: int = 8, tta: bool = True,
                  weight: str = "pyramid", threshold: Optional[float] = None,
                  device: DeviceLike = None, grid: Optional[Grid] = None,
                  slice_on_device: bool = True) -> np.ndarray:
    """Sliding-window tiled prediction with weighted fusion and D4 TTA
    (reference predict_tiled, inria_submit.py:237-257: step = patch/2,
    pyramid weights). Returns the HW float32 probabilities, or the uint8
    0/255 mask when ``threshold`` is given. ``grid``: tile-parallel over its
    data ranks (module docstring); every rank returns the whole result.
    ``slice_on_device=False``: the tiles are cut on the host (module
    docstring)."""
    dev = resolve_device(device)
    prep = _Prepared(image, test_transform, patch_size, batch_size, tta, weight, _ranks(grid),
                     slice_on_device)
    return _dispatch(prep, predict_fn, tta, threshold, dev, grid).cpu().numpy()


def predict_tiled_stream(items: Iterable[Tuple[object, Callable[[], np.ndarray]]],
                         predict_fn: Callable, test_transform=None,
                         patch_size: int = 224, batch_size: int = 8, tta: bool = True,
                         weight: str = "pyramid", threshold: Optional[float] = None,
                         depth: int = 1, device: DeviceLike = None,
                         grid: Optional[Grid] = None, slice_on_device: bool = True):
    """Pipelined :func:`predict_tiled` over many images: yields ``(key, mask)``
    in input order.

    ``items`` holds ``(key, load_fn)`` pairs, ``load_fn() -> HWC ndarray``. A
    producer thread loads and prepares image i+1 on the host (NumPy only)
    while this thread uploads and launches the sweep of image i; up to
    ``depth`` masks stay on the device before the oldest is fetched.
    ``depth=0`` is the serial path. ``grid`` and ``slice_on_device``: as
    :func:`predict_tiled`."""
    dev = resolve_device(device)
    items = list(items)
    if not items:
        return

    prepped: queue.Queue = queue.Queue(maxsize=max(1, depth + 1))
    stop = threading.Event()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                prepped.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for key, load_fn in items:
                with spans.span("segtpu_torch.stream.prepare", key):
                    prep = _Prepared(load_fn(), test_transform, patch_size, batch_size,
                                     tta, weight, _ranks(grid), slice_on_device)
                if not put((key, prep, None)):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            put((None, None, e))

    def fetch(k, m):
        with spans.span("segtpu_torch.stream.fetch", k):
            return k, m.cpu().numpy()

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    inflight = []
    try:
        for _ in range(len(items)):
            with spans.span("segtpu_torch.stream.wait") as waited:
                key, prep, error = prepped.get()
                waited.key = key
            if error is not None:
                raise error
            inflight.append((key, _dispatch(prep, predict_fn, tta, threshold, dev, grid, key)))
            if len(inflight) > depth:
                yield fetch(*inflight.pop(0))
        for k, m in inflight:
            yield fetch(k, m)
    finally:
        stop.set()
        worker.join(timeout=10.0)
