"""Model registry of the port (counterpart of segtpu/models/__init__.py).

``get_model(name, patch_size, num_channels, device=None, seed=0)`` builds the
model with weights drawn from ``torch.Generator().manual_seed(seed)`` on the
CPU, puts it in eval mode and moves it to ``device`` (CUDA unless the caller
passes ``device="cpu"``); on CUDA the model runs in ``channels_last`` memory.
Ported so far: ``linknet34``, ``unet``, ``unet_abn`` and ``zf_unet``, each at
segtpu's registry defaults (the U-Nets at 32 filters).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.models.layers import reset_parameters
from segtpu_torch.models.linknet import LinkNet34
from segtpu_torch.models.unet import UNet, UNetABN, ZF_UNET

_REGISTRY: Dict[str, Callable[[int, int], nn.Module]] = {
    "linknet34": lambda patch_size, num_channels: LinkNet34(num_classes=1,
                                                            num_channels=num_channels),
    "unet": lambda patch_size, num_channels: UNet(n_channels=num_channels),
    "unet_abn": lambda patch_size, num_channels: UNetABN(n_channels=num_channels),
    "zf_unet": lambda patch_size, num_channels: ZF_UNET(input_channels=num_channels),
}


def model_names():
    return sorted(_REGISTRY)


def get_model(model_name: str, patch_size: int = 224, num_channels: int = 3,
              device: DeviceLike = None, seed: int = 0) -> nn.Module:
    dev = resolve_device(device)
    name = model_name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"model {model_name!r} is not yet ported to segtpu_torch; "
                         f"ported: {model_names()}")
    model = _REGISTRY[name](patch_size, num_channels)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model.eval()
    return place_model(model, dev)


def place_model(model: nn.Module, device: DeviceLike = None) -> nn.Module:
    """``model`` on ``device`` (CUDA unless the caller passes the CPU), in
    ``channels_last`` memory on CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return model.to(device=dev, memory_format=torch.channels_last)
    return model.to(device=dev)
