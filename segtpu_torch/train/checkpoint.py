"""Checkpoints in the reference's ``.pth`` format (reference
torch_train.py:308-330): ``{model: state_dict, optimizer: state_dict, epoch,
loss, train_history, args}`` written with ``torch.save``, through a temporary
file and ``os.replace``. The harness keeps two: ``*_checkpoint.pth`` (the
best validation loss) and ``*_snapshot.pth`` (the last epoch).

segtpu's own snapshots are directories ``<name>.ckpt/`` holding
``state.msgpack`` (flax-serialised ``{params, batch_stats, opt_state}``) and
``meta.json`` (``{epoch, loss, train_history, args}``,
segtpu/train/checkpoint.py:4-9,34-63,72-105). :func:`load_flax_snapshot`
reads one into a port ``state_dict`` (``submit_cli -c <dir>.ckpt``);
:func:`save_flax_snapshot` writes one from a port model, for segtpu's
``restore_snapshot(..., restore_opt=False)``: its ``opt_state`` is empty,
since the port's optimizer state lives in its ``.pth``."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from segtpu_torch.compat import flax_msgpack
from segtpu_torch.compat.jax_params import jax_from_state_dict, state_dict_from_jax

META_KEYS = ("epoch", "loss", "train_history", "args")


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def write_snapshot(path: str, model_state: Dict[str, torch.Tensor],
                   optimizer_state: Optional[Dict[str, Any]] = None, **meta: Any) -> None:
    """Write a ``state_dict``, an optimizer ``state_dict`` (when given; the
    tensors on the CPU) and ``meta`` (any of ``epoch``, ``loss``,
    ``train_history``, ``args``) to ``path``."""
    unknown = set(meta) - set(META_KEYS)
    if unknown:
        raise ValueError(f"unknown snapshot fields {sorted(unknown)}; expected {META_KEYS}")
    ckpt = {"model": _to_cpu(model_state)}
    if optimizer_state is not None:
        ckpt["optimizer"] = _to_cpu(optimizer_state)
    ckpt.update({k: meta.get(k) for k in META_KEYS})
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def save_snapshot(path: str, model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                  **meta: Any) -> None:
    """Write ``model``'s weights, ``optimizer``'s state (when given) and
    ``meta`` to ``path`` (:func:`write_snapshot`)."""
    write_snapshot(path, model.state_dict(),
                   None if optimizer is None else optimizer.state_dict(), **meta)


def read_snapshot(path: str) -> Dict[str, Any]:
    """The whole snapshot dict of a ``.pth``, tensors on the CPU. Unpickled
    in full (the reference stores its ``args`` object there): load only
    checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)



def load_snapshot(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, meta) from a reference-format ``.pth``, tensors on the
    CPU; a file without optimizer state loads too."""
    ckpt = read_snapshot(path)
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
    ckpt = read_snapshot(path)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state; restore it with optimizer=None")
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["epoch"] + 1, ckpt["train_history"], ckpt["loss"]


FLAX_STATE, FLAX_META = "state.msgpack", "meta.json"


def load_flax_snapshot(path: str, model_name: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(state_dict, meta) from segtpu's ``<name>.ckpt`` directory: its
    params and batch stats through :func:`~segtpu_torch.compat.jax_params.state_dict_from_jax`,
    its ``meta.json`` as it is."""
    with open(os.path.join(path, FLAX_STATE), "rb") as f:
        raw = flax_msgpack.unpackb(f.read())
    with open(os.path.join(path, FLAX_META)) as f:
        meta = json.load(f)
    return state_dict_from_jax(model_name, raw["params"], raw.get("batch_stats", {})), meta


def save_flax_snapshot(path: str, model_name: str, state_dict: Dict[str, torch.Tensor],
                       epoch: int, loss: float, train_history: Dict[str, list],
                       args: str = "") -> None:
    """Write ``state_dict`` as segtpu's ``<name>.ckpt`` directory (the
    counterpart of segtpu's ``save_snapshot``), ``opt_state`` empty."""
    params, stats = jax_from_state_dict(model_name, state_dict)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FLAX_STATE + ".tmp")
    with open(tmp, "wb") as f:
        f.write(flax_msgpack.packb({"params": params, "batch_stats": stats, "opt_state": {}}))
    os.replace(tmp, os.path.join(path, FLAX_STATE))
    with open(os.path.join(path, FLAX_META), "w") as f:
        json.dump({"epoch": int(epoch), "loss": float(loss), "train_history": train_history,
                   "args": args}, f)
