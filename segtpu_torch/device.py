"""The port's one device rule: entry points run on CUDA unless the caller asks
for the CPU, and a missing GPU is an error, never a silent switch."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segtpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev



def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (first card), for every number a
    measurement keeps."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
