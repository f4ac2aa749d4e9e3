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

