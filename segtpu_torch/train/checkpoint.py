"""Checkpoints in the reference's ``.pth`` format (reference
torch_train.py:308-330): ``{model: state_dict, optimizer: state_dict, epoch,
loss, train_history, args}`` written with ``torch.save``, through a temporary
file and ``os.replace``. The harness keeps two: ``*_checkpoint.pth`` (the
best validation loss) and ``*_snapshot.pth`` (the last epoch). Reading
segtpu's flax ``.ckpt`` directories belongs to a later slice of the port."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

META_KEYS = ("epoch", "loss", "train_history", "args")


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def save_snapshot(path: str, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                  **meta: Any) -> None:
    """Write ``model``'s weights, ``optimizer``'s state (when given; the
    tensors on the CPU) and ``meta`` (any of ``epoch``, ``loss``,
    ``train_history``, ``args``) to ``path``."""
    unknown = set(meta) - set(META_KEYS)
    if unknown:
        raise ValueError(f"unknown snapshot fields {sorted(unknown)}; expected {META_KEYS}")
    ckpt = {"model": _to_cpu(model.state_dict())}
    if optimizer is not None:
        ckpt["optimizer"] = _to_cpu(optimizer.state_dict())
    ckpt.update({k: meta.get(k) for k in META_KEYS})
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def _load(path: str) -> Dict[str, Any]:
    # unpickled in full (the reference stores its ``args`` object there):
    # load only checkpoints you trust
    return torch.load(path, map_location="cpu", weights_only=False)


def load_snapshot(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, meta) from a reference-format ``.pth``, tensors on the
    CPU; a file without optimizer state loads too."""
    ckpt = _load(path)
    return ckpt["model"], {k: ckpt.get(k) for k in META_KEYS}


def restore_snapshot(path: str, model: nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> Tuple[int, Dict[str, list], float]:
    """Load ``path`` into ``model`` (and ``optimizer``) in place and return
    ``(start_epoch, train_history, best_loss)``: the epoch after the saved
    one, its history and its loss (segtpu/train/checkpoint.py:72-105).
    ``optimizer=None`` leaves the optimizer state out (segtpu's
    ``restore_opt=False``), so the file may come from another optimizer;
    otherwise its state is loaded onto the device of the model's
    parameters."""
    ckpt = _load(path)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state; restore it with optimizer=None")
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["epoch"] + 1, ckpt["train_history"], ckpt["loss"]
