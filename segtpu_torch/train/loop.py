"""Epoch runners: the train and eval steps over a loader, host meters and
TensorBoard logging (counterpart of segtpu/train/loop.py).

The reference's train()/validate() logging (torch_train.py:159-305):
per-batch loss and metric scalars, the per-batch gradient abs-max, per-epoch
image grids of input, target and sigmoid prediction, per-epoch parameter
histograms, and the PR curve of the last validation batch. Unlike the
reference, no batch waits for the host: each step's logs stay 0-d tensors on
the device, and the epoch's logs are stacked and fetched once at its end
(one ``torch.stack(...).cpu()`` per key), as segtpu's ``_fetch_logs``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from segtpu_torch import spans
from segtpu_torch.data.pipeline import prefetch_to_device
from segtpu_torch.device import DeviceLike
from segtpu_torch.ops.meters import AverageMeter, PRCurveMeter
from segtpu_torch.utils import make_grid

Meters = Tuple[AverageMeter, Dict[str, AverageMeter]]


def _fetch_logs(batch_logs: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """``{key: [n_batches] array}`` from per-batch 0-d tensors, one host
    transfer per key. ``pr_counts`` is left out (only the last batch's is
    read)."""
    if not batch_logs:
        return {}
    keys = [k for k in batch_logs[0] if k != "pr_counts"]
    return {k: torch.stack([logs[k] for logs in batch_logs]).float().cpu().numpy() for k in keys}


def _update_meters(logs: Dict[str, np.ndarray], metric_names, epoch: int, n_batches: int,
                   prefix: str, writer) -> Meters:
    """The epoch's meters from its fetched logs; with a writer, each batch's
    loss, gradient abs-max (train steps) and metrics."""
    losses = AverageMeter()
    scores = {k: AverageMeter() for k in metric_names}
    for i in range(len(logs.get("loss", ()))):
        step_idx = epoch * n_batches + i
        losses.update(float(logs["loss"][i]))
        if writer is not None:
            writer.add_scalar(f"{prefix}/batch/loss", float(logs["loss"][i]), step_idx)
            if "grad_absmax" in logs:
                writer.add_scalar(f"{prefix}/grad/global_abs_max", float(logs["grad_absmax"][i]),
                                  step_idx)
        for k in metric_names:
            scores[k].update(float(logs[k][i]))
            if writer is not None:
                writer.add_scalar(f"{prefix}/batch/{k}", float(logs[k][i]), step_idx)
    return losses, scores


def _log_images(writer, prefix: str, model, batch, epoch: int) -> None:
    """Grids of x, y and sigmoid(model(x)) of the first 8 samples of
    ``batch``, the model in eval mode."""
    x, y = batch[0][:8], batch[1][:8]
    model.eval()
    with torch.inference_mode():
        pred = torch.sigmoid(model(x).float())
    writer.add_image(f"{prefix}/image", make_grid(x), epoch, dataformats="HWC")
    writer.add_image(f"{prefix}/y_true", make_grid(y), epoch, dataformats="HWC")
    writer.add_image(f"{prefix}/y_pred", make_grid(pred), epoch, dataformats="HWC")


def _log_epoch(writer, prefix: str, losses: AverageMeter, scores, epoch: int) -> None:
    writer.add_scalar(f"{prefix}/epoch/loss", losses.avg, epoch)
    for k, m in scores.items():
        writer.add_scalar(f"{prefix}/epoch/{k}", m.avg, epoch)


def run_train_epoch(train_step, loader, lr: float, epoch: int, metric_names, writer=None,
                    device: DeviceLike = None, log_images: bool = True,
                    log_histograms: bool = True) -> Meters:
    """One training epoch of ``train_step`` (``make_train_step``) over
    ``loader``, batches staged on ``device`` (CUDA unless the caller passes
    the CPU). Returns ``(loss_meter, {metric: meter})``."""
    batch_logs, last_batch = [], None
    batches = prefetch_to_device(loader, device)
    while True:
        with spans.span("segtpu_torch.loader.wait"):
            batch = next(batches, None)
        if batch is None:
            break
        batch_logs.append(train_step(batch[0], batch[1], lr))
        last_batch = batch

    logs = _fetch_logs(batch_logs)
    losses, scores = _update_meters(logs, metric_names, epoch, len(loader), "train", writer)
    if writer is not None:
        model = train_step.model
        if log_images and last_batch is not None:
            _log_images(writer, "train", model, last_batch, epoch)
        _log_epoch(writer, "train", losses, scores, epoch)
        if log_histograms:
            for name, p in model.named_parameters():
                writer.add_histogram("model/" + name.replace(".", "/"),
                                     p.detach().float().cpu().numpy(), epoch, bins="doane")
    return losses, scores


def run_validate_epoch(eval_step, loader, epoch: int, metric_names, writer=None,
                       device: DeviceLike = None, transform_fn=None) -> Meters:
    """One validation epoch of ``eval_step`` (``make_eval_step``). Returns
    ``(loss_meter, {metric: meter})``; with a writer, also the image grids of
    the last batch and the raw PR curve of its ``pr_counts``.
    ``transform_fn(x, y) -> (x, y)``: a deterministic transform of each
    batch on the device before the step, e.g. the normalisation of a raw
    loader (segtpu's ``make_eval_step(transform_fn=...)``)."""
    batch_logs, last_batch = [], None
    for batch in prefetch_to_device(loader, device):
        if transform_fn is not None:
            batch = transform_fn(*batch)
        batch_logs.append(eval_step(batch[0], batch[1]))
        last_batch = batch

    logs = _fetch_logs(batch_logs)
    losses, scores = _update_meters(logs, metric_names, epoch, len(loader), "val", writer)
    if writer is not None and batch_logs:
        _log_images(writer, "val", eval_step.model, last_batch, epoch)
        _log_epoch(writer, "val", losses, scores, epoch)
        if "pr_counts" in batch_logs[-1]:
            pr_meter = PRCurveMeter()
            pr_meter.update_counts(*(c.cpu().numpy() for c in batch_logs[-1]["pr_counts"]))
            writer.add_pr_curve_raw(
                "val/pr_curve", true_positive_counts=pr_meter.tp,
                true_negative_counts=pr_meter.tn, false_positive_counts=pr_meter.fp,
                false_negative_counts=pr_meter.fn, precision=pr_meter.precision(),
                recall=pr_meter.recall(), global_step=epoch,
                num_thresholds=pr_meter.n_thresholds)
    return losses, scores
