"""Pretrained encoder weights from a local torchvision-format file
(counterpart of segtpu/compat/encoder_weights.py).

The reference's models load ImageNet weights at construction; the port,
like segtpu, takes a local file instead (``--encoder-weights <file.pth>`` in
the train and submit CLIs) and loads it into the model's encoder before any
checkpoint. The port's modules keep torchvision's and the reference's names,
so the transplant is a renaming of prefixes: ResNet ``conv1``, ``bn1``,
``layer1..4`` (basic or bottleneck blocks, ``downsample.{0,1}``) go to where
each model keeps them, VGG ``features.N`` to the UNet11/UNet16 stages.

Accepted file contents: a raw ``state_dict`` (``fc.*`` / ``classifier.*``
and anything outside the encoder are ignored) or a dict wrapping one under
``state_dict`` or ``model``. Weights and running statistics load;
``num_batches_tracked`` is left as the model has it (segtpu keeps no such
counter). A first conv with 3 input channels in the file and 1 in the model
(``-g``) takes the sum over RGB, as segtpu does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from segtpu_torch.compat.jax_params import _layers_map, _linknet_enc_map
from segtpu_torch.models import ENCODER_PREFIXES

_RESNET_TOPS = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")

# conv indices within torchvision's vgg ``features`` for each encoder stage
VGG_LAYOUT = {
    "vgg11": {"conv1": (0,), "conv2": (3,), "conv3": (6, 8), "conv4": (11, 13),
              "conv5": (16, 18)},
    "vgg16": {"conv1": (0, 2), "conv2": (5, 7), "conv3": (10, 12, 14),
              "conv4": (17, 19, 21), "conv5": (24, 26, 28)},
}

# model -> ("resnet", torchvision top-level name -> the model's prefix) or
# ("vgg", arch); the models of segtpu's ENCODER_SPECS
ENCODER_SPECS: Dict[str, Tuple[str, object]] = {
    "linknet34": ("resnet", _linknet_enc_map()),
    "dilated_linknet34": ("resnet", _linknet_enc_map()),
    "albunet": ("resnet", {k: "encoder." + k for k in _RESNET_TOPS}),
    "gcn34": ("resnet", _layers_map("layer1.1")),
    "gcn": ("resnet", _layers_map("layer1.1")),
    "psp_net": ("resnet", _layers_map()),
    "duc": ("resnet", _layers_map()),
    "duc_dc": ("resnet", _layers_map()),
    "unet11": ("vgg", "vgg11"),
    "unet16": ("vgg", "vgg16"),
}


def unwrap_state_dict(obj):
    """The state_dict inside ``obj``: ``obj`` itself when it maps names to
    tensors, else its ``state_dict`` or ``model`` entry."""
    if isinstance(obj, Mapping):
        if not any(k in obj for k in ("state_dict", "model")):
            return obj
        for key in ("state_dict", "model"):
            if key in obj:
                return obj[key]
    raise ValueError("the encoder weights file holds no state_dict")


def encoder_state_dict(model_name: str, state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A torchvision-format ``state_dict`` renamed to the port's keys of
    ``model_name``'s encoder. Raises ``KeyError`` for a model that takes no
    encoder weights and for a VGG file that lacks a stage's conv."""
    spec = ENCODER_SPECS.get(model_name.lower())
    if spec is None:
        raise KeyError(f"model '{model_name}' takes no pretrained encoder weights; "
                       f"supported: {sorted(ENCODER_SPECS)}")
    kind, layout = spec
    out: Dict[str, torch.Tensor] = {}
    if kind == "resnet":
        for key, value in state_dict.items():
            top, _, rest = key.partition(".")
            if top in layout and not key.endswith("num_batches_tracked"):
                out[f"{layout[top]}.{rest}"] = value
        return out
    for stage, idxs in VGG_LAYOUT[layout].items():
        for i, li in enumerate(idxs):
            for leaf in ("weight", "bias"):
                out[f"{stage}.{2 * i}.{leaf}"] = state_dict[f"features.{li}.{leaf}"]
    return out


def install_encoder_weights(model_name: str, model: nn.Module, weights_file: str) -> None:
    """Load ``weights_file`` into ``model``'s encoder in place. Every
    encoder tensor of the model must come from the file with its shape
    (``ValueError`` / ``KeyError`` otherwise)."""
    obj = torch.load(weights_file, map_location="cpu", weights_only=False)
    enc = encoder_state_dict(model_name, unwrap_state_dict(obj))
    own = model.state_dict()
    prefixes = ENCODER_PREFIXES[model_name.lower()]
    needed = {k for k in own if k.startswith(prefixes) and not k.endswith("num_batches_tracked")}
    missing = needed - set(enc)
    if missing:
        raise KeyError(f"encoder weights lack {sorted(missing)[:5]} "
                       f"({len(missing)} keys) - wrong architecture file?")
    for key, value in enc.items():
        if key not in own:
            raise KeyError(f"encoder weights key '{key}' is not in model '{model_name}'")
        have, want = tuple(own[key].shape), tuple(value.shape)
        if (len(have) == 4 and len(want) == 4 and have[1] == 1 and want[1] == 3
                and have[0] == want[0]):
            value = value.sum(dim=1, keepdim=True)
            want = tuple(value.shape)
        if have != want:
            raise ValueError(f"encoder weight '{key}' shape {want} does not match the "
                             f"model's {have} - wrong architecture file?")
        enc[key] = value
    model.load_state_dict(enc, strict=False)
