"""segtpu parameter trees -> a PyTorch state_dict for the port's modules
(counterpart of segtpu/compat/torch_import.py ``export_state_dict``).

segtpu keeps a model's weights as two nested dicts, ``params`` and
``batch_stats``, with NHWC kernels. :func:`state_dict_from_jax` takes them as
nested dicts of numpy arrays and returns tensors under the reference's
state_dict keys, which are the port's module names, so
``model.load_state_dict`` takes the result directly. Rules: conv HWIO ->
OIHW; deconv HWOI -> (in, out, kh, kw) (the same transpose); BN/ABN
scale/bias/mean/var -> weight/bias/running_mean/running_var.
``num_batches_tracked`` (which segtpu does not keep) is set to 0 for every
plain BatchNorm, as a freshly built ``nn.BatchNorm2d`` has it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Entry = Tuple[str, str, Tuple[str, ...]]  # (kind, torch_prefix, segtpu_path)
# kinds: conv | deconv | bn (BatchNorm) | abn (InPlaceABN); a trailing '?'
# marks an entry that is present only in some blocks (downsample branches)


def _entries_resnet_encoder(prefix_map: Dict[str, str], layers,
                            root: Tuple[str, ...] = ("encoder",)) -> List[Entry]:
    """torchvision-style BasicBlock ResNet keys under arbitrary attribute
    prefixes (segtpu torch_import.py:109-129)."""
    E: List[Entry] = [
        ("conv", prefix_map["conv1"], root + ("conv1", "Conv_0")),
        ("bn", prefix_map["bn1"], root + ("bn1",)),
    ]
    for li, n_blocks in enumerate(layers):
        lp = prefix_map[f"layer{li + 1}"]
        for b in range(n_blocks):
            tp = f"{lp}.{b}"
            name = root + (f"layer{li + 1}_{b}",)
            for ci in (1, 2):
                E.append(("conv", f"{tp}.conv{ci}", name + (f"conv{ci}", "Conv_0")))
                E.append(("bn", f"{tp}.bn{ci}", name + (f"bn{ci}",)))
            E.append(("conv?", f"{tp}.downsample.0", name + ("downsample_conv", "Conv_0")))
            E.append(("bn?", f"{tp}.downsample.1", name + ("downsample_bn",)))
    return E


def _linknet_enc_map() -> Dict[str, str]:
    m = {"conv1": "firstconv", "bn1": "firstbn"}
    for i in range(1, 5):
        m[f"layer{i}"] = f"encoder{i}"
    return m


def _entries_linknet34() -> List[Entry]:
    """reference lib/models/linknet.py:33-90 (segtpu torch_import.py:139-157)."""
    E = _entries_resnet_encoder(_linknet_enc_map(), (3, 4, 6, 3))
    for i in range(1, 5):
        tp, fp = f"decoder{i}", (f"decoder{i}",)
        E += [
            ("conv", f"{tp}.conv1", fp + ("conv1", "Conv_0")),
            ("abn", f"{tp}.abn1", fp + ("n1_abn",)),
            ("deconv", f"{tp}.deconv2", fp + ("deconv2", "ConvTranspose_0")),
            ("abn", f"{tp}.abn2", fp + ("n2_abn",)),
            ("conv", f"{tp}.conv3", fp + ("conv3", "Conv_0")),
            ("abn", f"{tp}.abn3", fp + ("n3_abn",)),
        ]
    E += [
        ("deconv", "finaldeconv1", ("finaldeconv1", "ConvTranspose_0")),
        ("conv", "finalconv2", ("finalconv2", "Conv_0")),
        ("conv", "finalconv3", ("finalconv3", "Conv_0")),
    ]
    return E


_ENTRY_BUILDERS = {"linknet34": _entries_linknet34}


def _get(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for key in path:
        if node is None or key not in node:
            return None
        node = node[key]
    return node


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def state_dict_from_jax(model_name: str, params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Torch-format state_dict (float32 CPU tensors) from segtpu's
    ``params``/``batch_stats`` trees of ``model_name``. Raises ``ValueError``
    for a model the port does not have and ``KeyError`` for a missing leaf."""
    name = model_name.lower()
    if name not in _ENTRY_BUILDERS:
        raise ValueError(f"model {model_name!r} is not yet ported to segtpu_torch; "
                         f"ported: {sorted(_ENTRY_BUILDERS)}")
    sd: Dict[str, torch.Tensor] = {}
    for kind, tp, path in _ENTRY_BUILDERS[name]():
        optional = kind.endswith("?")
        kind = kind.rstrip("?")
        node = _get(params, path)
        if node is None:
            if optional:
                continue
            raise KeyError("/".join(path))
        if kind in ("bn", "abn"):
            stats = _get(batch_stats, path)
            if stats is None:
                raise KeyError("batch_stats/" + "/".join(path))
            sd[tp + ".weight"] = _tensor(node["scale"])
            sd[tp + ".bias"] = _tensor(node["bias"])
            sd[tp + ".running_mean"] = _tensor(stats["mean"])
            sd[tp + ".running_var"] = _tensor(stats["var"])
            if kind == "bn":
                sd[tp + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            continue
        # conv HWIO -> OIHW; deconv HWOI -> (in, out, kh, kw): same transpose
        sd[tp + ".weight"] = _tensor(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        if "bias" in node:
            sd[tp + ".bias"] = _tensor(node["bias"])
    return sd
