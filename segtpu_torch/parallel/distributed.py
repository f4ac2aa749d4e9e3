"""Multi-process bootstrap (counterpart of segtpu/parallel/distributed.py).

:func:`maybe_initialize_distributed` starts torch's default process group
when the variables that ``torchrun`` sets are present (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and is a
no-op otherwise, so one CLI runs alone or as one rank of many:

    torchrun --nproc_per_node 4 -m segtpu_torch.train_cli -m linknet34 ...

The backend follows the device: NCCL for CUDA, gloo for the CPU. Rank r
runs on ``cuda:LOCAL_RANK`` (:func:`rank_device`). A caller that needs
another backend (two ranks on one card, which NCCL refuses, run over gloo)
passes ``backend=``; nothing switches backend or device on failure.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from segtpu_torch.device import DeviceLike, resolve_device

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when every launcher variable is set; raises ``RuntimeError`` when
    only some are (a half-configured launch is an error, not a single run)."""
    present = [v for v in LAUNCH_VARS if v in os.environ]
    if present and len(present) != len(LAUNCH_VARS):
        missing = [v for v in LAUNCH_VARS if v not in os.environ]
        raise RuntimeError(f"launcher variables {present} are set but {missing} are not")
    return bool(present)


def rank_device(device: DeviceLike = None) -> torch.device:
    """:func:`~segtpu_torch.device.resolve_device`, with a CUDA device that
    names no index placed on ``cuda:LOCAL_RANK`` under a launcher."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        index = int(os.environ.get("LOCAL_RANK", "0")) if launched() else torch.cuda.current_device()
        dev = torch.device("cuda", index)
    return dev


def maybe_initialize_distributed(device: DeviceLike = None,
                                 backend: Optional[str] = None) -> bool:
    """Initialise the default process group from the launcher variables.
    Returns True when running as one of several ranks (also when the group
    was already initialised), False when the variables are absent."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True
