"""Checkpoints in the reference's ``.pth`` format (reference
torch_train.py:308-316): ``{model: state_dict, epoch, loss, train_history,
args}`` written with ``torch.save``. Reading segtpu's flax ``.ckpt``
directories belongs to a later slice of the port."""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

META_KEYS = ("epoch", "loss", "train_history", "args")


def save_snapshot(path: str, model: nn.Module, **meta: Any) -> None:
    """Write ``model``'s weights (on the CPU) and ``meta`` (any of
    ``epoch``, ``loss``, ``train_history``, ``args``) to ``path``."""
    unknown = set(meta) - set(META_KEYS)
    if unknown:
        raise ValueError(f"unknown snapshot fields {sorted(unknown)}; expected {META_KEYS}")
    ckpt = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    ckpt.update({k: meta.get(k) for k in META_KEYS})
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_snapshot(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, meta) from a reference-format ``.pth``, tensors on the
    CPU. The file is unpickled in full (the reference stores its ``args``
    object there), so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["model"], {k: ckpt.get(k) for k in META_KEYS}
