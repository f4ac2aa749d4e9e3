"""Model registry of the port (counterpart of segtpu/models/__init__.py).

``get_model(name, patch_size, num_channels, device=None, seed=0)`` builds the
model with weights drawn from ``torch.Generator().manual_seed(seed)`` on the
CPU, puts it in eval mode and moves it to ``device`` (CUDA unless the caller
passes ``device="cpu"``); on CUDA the model runs in ``channels_last`` memory.
All 18 of segtpu's registry names, each at segtpu's registry defaults:
``linknet34`` and ``dilated_linknet34``, ``unet``, ``unet_abn`` and
``zf_unet`` (32 filters), ``unet11``, ``unet16`` and ``albunet`` (32
filters), ``tiramisu57``, ``tiramisu67`` and ``tiramisu103``, ``gcn``
(ResNet-152) and ``gcn34``, ``psp_net``, ``duc`` and ``duc_dc``,
``linknext`` and ``squeezenet``. As in segtpu, the WideResNet classifier
(:mod:`segtpu_torch.models.wider_resnet`) and the blocks of
:mod:`segtpu_torch.models.blocks` are not in the registry; any other name
raises ``ValueError``.

``ENCODER_PREFIXES`` names each model's encoder, the parameters that
``--freeze-encoder`` freezes.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Set

import torch
from torch import nn

from segtpu_torch.device import DeviceLike, resolve_device
from segtpu_torch.models.albunet import AlbuNet
from segtpu_torch.models.duc_hdc import ResNetDUC, ResNetDUCHDC
from segtpu_torch.models.gcn import GCN34, GCN152
from segtpu_torch.models.layers import reset_parameters
from segtpu_torch.models.linknet import DilatedLinkNet34, LinkNet34
from segtpu_torch.models.linknext import LinkNext
from segtpu_torch.models.psp import PSPNet
from segtpu_torch.models.squeezenet import SqueezeNet
from segtpu_torch.models.ternaus import UNet11, UNet16
from segtpu_torch.models.tiramisu import FCDenseNet57, FCDenseNet67, FCDenseNet103
from segtpu_torch.models.unet import UNet, UNetABN, ZF_UNET

_REGISTRY: Dict[str, Callable[[int, int], nn.Module]] = {
    "linknet34": lambda patch_size, num_channels: LinkNet34(num_classes=1,
                                                            num_channels=num_channels),
    "unet": lambda patch_size, num_channels: UNet(n_channels=num_channels),
    "unet_abn": lambda patch_size, num_channels: UNetABN(n_channels=num_channels),
    "zf_unet": lambda patch_size, num_channels: ZF_UNET(input_channels=num_channels),
    "unet11": lambda patch_size, num_channels: UNet11(num_channels=num_channels),
    "unet16": lambda patch_size, num_channels: UNet16(num_channels=num_channels),
    "albunet": lambda patch_size, num_channels: AlbuNet(num_channels=num_channels),
    "tiramisu57": lambda patch_size, num_channels: FCDenseNet57(in_channels=num_channels),
    "tiramisu67": lambda patch_size, num_channels: FCDenseNet67(in_channels=num_channels),
    "tiramisu103": lambda patch_size, num_channels: FCDenseNet103(in_channels=num_channels),
    "dilated_linknet34": lambda patch_size, num_channels: DilatedLinkNet34(
        num_channels=num_channels),
    "gcn": lambda patch_size, num_channels: GCN152(num_channels=num_channels),
    "gcn34": lambda patch_size, num_channels: GCN34(num_channels=num_channels),
    # the reference registry's PSPNet(use_aux=False, num_classes=1)
    "psp_net": lambda patch_size, num_channels: PSPNet(num_channels=num_channels),
    "duc": lambda patch_size, num_channels: ResNetDUC(num_channels=num_channels),
    "duc_dc": lambda patch_size, num_channels: ResNetDUCHDC(num_channels=num_channels),
    "linknext": lambda patch_size, num_channels: LinkNext(num_channels=num_channels),
    "squeezenet": lambda patch_size, num_channels: SqueezeNet(in_channels=num_channels),
}

# Parameter-name prefixes of each model's encoder: the modules under segtpu's
# ENCODER_SPECS paths (segtpu/compat/encoder_weights.py:44-67), or under a
# top-level "encoder" subtree where a model has no spec (LinkNext's), by the
# names that compat/jax_params.py maps them to. SqueezeNet has none.
_VGG_STAGES = ("conv1.", "conv2.", "conv3.", "conv4.", "conv5.")
_LINKNET_ENCODER = ("firstconv.", "firstbn.", "encoder1.", "encoder2.", "encoder3.", "encoder4.")
_LAYERS_ENCODER = ("layer0.", "layer1.", "layer2.", "layer3.", "layer4.")
ENCODER_PREFIXES = {
    "linknet34": _LINKNET_ENCODER,
    "dilated_linknet34": _LINKNET_ENCODER,
    "unet11": _VGG_STAGES,
    "unet16": _VGG_STAGES,
    "albunet": ("encoder.",),
    "gcn": _LAYERS_ENCODER,
    "gcn34": _LAYERS_ENCODER,
    "psp_net": _LAYERS_ENCODER,
    "duc": _LAYERS_ENCODER,
    "duc_dc": _LAYERS_ENCODER,
    "linknext": ("encoder0.", "encoder1.", "encoder2.", "encoder3.", "encoder4."),
}


def model_names():
    return sorted(_REGISTRY)


def without_encoder(model_name: str, names: Iterable[str]) -> Set[str]:
    """The parameter names among ``names`` outside ``model_name``'s encoder:
    what trains under ``--freeze-encoder``. Raises ``ValueError`` for a model
    with no encoder."""
    prefixes = ENCODER_PREFIXES.get(model_name.lower())
    if prefixes is None:
        raise ValueError(f"model '{model_name}' has no encoder subtree")
    return {n for n in names if not n.startswith(prefixes)}


def get_model(model_name: str, patch_size: int = 224, num_channels: int = 3,
              device: DeviceLike = None, seed: int = 0) -> nn.Module:
    dev = resolve_device(device)
    name = model_name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"no model {model_name!r} in the registry; "
                         f"the registry: {model_names()}")
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
