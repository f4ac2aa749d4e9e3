"""segtpu parameter trees -> a PyTorch state_dict for the port's modules
(counterpart of segtpu/compat/torch_import.py ``export_state_dict``).

segtpu keeps a model's weights as two nested dicts, ``params`` and
``batch_stats``, with NHWC kernels. :func:`state_dict_from_jax` takes them as
nested dicts of numpy arrays and returns tensors under the reference's
state_dict keys, which are the port's module names, so
``model.load_state_dict`` takes the result directly. Rules: conv HWIO ->
OIHW; deconv HWOI -> (in, out, kh, kw) (the same transpose); dense
(in, out) -> linear (out, in); BN/ABN scale/bias/mean/var ->
weight/bias/running_mean/running_var.
``num_batches_tracked`` (which segtpu does not keep) is set to 0 for every
plain BatchNorm, as a freshly built ``nn.BatchNorm2d`` has it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

Entry = Tuple[str, str, Tuple[str, ...]]  # (kind, torch_prefix, segtpu_path)
# kinds: conv | deconv | linear | bn (BatchNorm, ABN) | abn (InPlaceABN); a
# trailing '?' marks an entry that is present only in some blocks
# (downsample branches)


def _entries_resnet_encoder(prefix_map: Dict[str, str], layers,
                            root: Tuple[str, ...] = ("encoder",),
                            bottleneck: bool = False) -> List[Entry]:
    """torchvision-style ResNet keys under arbitrary attribute prefixes
    (segtpu torch_import.py:109-129): two convs per BasicBlock, three per
    Bottleneck."""
    E: List[Entry] = [
        ("conv", prefix_map["conv1"], root + ("conv1", "Conv_0")),
        ("bn", prefix_map["bn1"], root + ("bn1",)),
    ]
    convs = (1, 2, 3) if bottleneck else (1, 2)
    for li, n_blocks in enumerate(layers):
        lp = prefix_map[f"layer{li + 1}"]
        for b in range(n_blocks):
            tp = f"{lp}.{b}"
            name = root + (f"layer{li + 1}_{b}",)
            for ci in convs:
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


def _entries_dilated_linknet34() -> List[Entry]:
    """reference dilated_linknet.py:42-99 as segtpu fixes it (segtpu
    torch_import.py:160-210): segtpu's LinkNet34 under ``linknet``, plain
    BatchNorms ``norm1..3``, and ``deconv2`` a 3x3 conv in decoder4 and
    decoder3."""
    root = ("linknet",)
    E = _entries_resnet_encoder(_linknet_enc_map(), (3, 4, 6, 3), root=root + ("encoder",))
    for i in range(1, 5):
        tp, fp = f"decoder{i}", root + (f"decoder{i}",)
        stride1 = i in (3, 4)
        E += [
            ("conv", f"{tp}.conv1", fp + ("conv1", "Conv_0")),
            ("bn", f"{tp}.norm1", fp + ("n1_bn",)),
            ("conv" if stride1 else "deconv", f"{tp}.deconv2",
             fp + ("deconv2", "Conv_0" if stride1 else "ConvTranspose_0")),
            ("bn", f"{tp}.norm2", fp + ("n2_bn",)),
            ("conv", f"{tp}.conv3", fp + ("conv3", "Conv_0")),
            ("bn", f"{tp}.norm3", fp + ("n3_bn",)),
        ]
    E += [
        ("deconv", "finaldeconv1", root + ("finaldeconv1", "ConvTranspose_0")),
        ("conv", "finalconv2", root + ("finalconv2", "Conv_0")),
        ("conv", "finalconv3", root + ("finalconv3", "Conv_0")),
    ]
    return E


def _entries_double_conv(tp: str, fp: Tuple[str, ...], abn: bool) -> List[Entry]:
    """The reference's double-conv Sequential: conv 0, BN 1, conv 3, BN 4;
    with InPlaceABN conv 0, ABN 1, conv 2, ABN 3 (segtpu
    torch_import.py:65-78)."""
    if abn:
        idx = [("conv", 0, "conv0"), ("abn", 1, "abn0"), ("conv", 2, "conv1"), ("abn", 3, "abn1")]
    else:
        idx = [("conv", 0, "conv0"), ("bn", 1, "bn0"), ("conv", 3, "conv1"), ("bn", 4, "bn1")]
    return [(kind, f"{tp}.{i}", fp + ((name, "Conv_0") if kind == "conv" else (name,)))
            for kind, i, name in idx]


def _entries_unet(root: Tuple[str, ...] = (), abn: bool = False) -> List[Entry]:
    """reference lib/models/unet.py:80-107 and unet_abn.py (segtpu
    torch_import.py:81-91); ``root`` is segtpu's path to the UNet. The
    transposed convs ``up{k}.up`` of ``UNet(upsample=False)`` are mapped
    where the tree has them (segtpu names them ``ConvTranspose2dTorch_0``)."""
    E = _entries_double_conv("inc.conv.conv", root + ("inc",), abn)
    for i in range(1, 5):
        E += _entries_double_conv(f"down{i}.mpconv.1.conv", root + (f"down{i}",), abn)
    for i in range(1, 5):
        E.append(("deconv?", f"up{i}.up",
                  root + (f"up{i}", "ConvTranspose2dTorch_0", "ConvTranspose_0")))
        E += _entries_double_conv(f"up{i}.conv.conv", root + (f"up{i}", "conv"), abn)
    E.append(("conv", "outc.conv", root + ("outc", "Conv_0")))
    return E


def _entries_zf_unet() -> List[Entry]:
    """reference lib/models/zf_unet.py:35-95 (segtpu torch_import.py:94-106)."""
    names = ["conv_224", "conv_112", "conv_56", "conv_28", "conv_14", "conv_7",
             "up_conv_14", "up_conv_28", "up_conv_56", "up_conv_112", "up_conv_224"]
    E: List[Entry] = []
    for name in names:
        for i, attr in enumerate(("l1", "l2")):
            E.append(("conv", f"{name}.{attr}.conv", (name, f"conv{i}", "Conv_0")))
            E.append(("bn", f"{name}.{attr}.bn", (name, f"bn{i}")))
    E.append(("conv", "conv_final", ("conv_final", "Conv_0")))
    return E


def _entries_decoder_blocks(names) -> List[Entry]:
    """TernausNet's DecoderBlock: the ConvRelu ``block.0.conv`` and the
    transposed conv ``block.1`` (segtpu torch_import.py:203-207)."""
    E: List[Entry] = []
    for name in names:
        E.append(("conv", f"{name}.block.0.conv", (name, "convrelu", "conv", "Conv_0")))
        E.append(("deconv", f"{name}.block.1", (name, "deconv", "ConvTranspose_0")))
    return E


def _entries_ternaus(vgg16: bool) -> List[Entry]:
    """reference unet11.py:51-122 / unet16.py:52-131 (segtpu
    torch_import.py:189-209)."""
    stage_convs = (
        {"conv1": [0, 2], "conv2": [0, 2], "conv3": [0, 2, 4],
         "conv4": [0, 2, 4], "conv5": [0, 2, 4]}
        if vgg16 else
        {"conv1": [0], "conv2": [0], "conv3": [0, 2],
         "conv4": [0, 2], "conv5": [0, 2]}
    )
    E: List[Entry] = []
    for stage, idxs in stage_convs.items():
        for i, li in enumerate(idxs):
            E.append(("conv", f"{stage}.{li}", (stage, f"conv{i}", "Conv_0")))
    E += _entries_decoder_blocks(("center", "dec5", "dec4", "dec3", "dec2"))
    E.append(("conv", "dec1.conv", ("dec1", "conv", "Conv_0")))
    E.append(("conv", "final", ("final", "Conv_0")))
    return E


def _entries_albunet() -> List[Entry]:
    """segtpu's AlbuNet (albunet.py:52-85), which segtpu's exporter does not
    map: torchvision's ResNet-34 keys under ``encoder.`` (the tree of
    segtpu's ENCODER_SPECS["albunet"]), TernausNet's decoder blocks, then
    ``dec0.conv`` and ``final``."""
    prefix_map = {"conv1": "encoder.conv1", "bn1": "encoder.bn1"}
    for i in range(1, 5):
        prefix_map[f"layer{i}"] = f"encoder.layer{i}"
    E = _entries_resnet_encoder(prefix_map, (3, 4, 6, 3))
    E += _entries_decoder_blocks(("center", "dec5", "dec4", "dec3", "dec2", "dec1"))
    E.append(("conv", "dec0.conv", ("dec0", "conv", "Conv_0")))
    E.append(("conv", "final", ("final", "Conv_0")))
    return E


def _entries_tiramisu(down_blocks, up_blocks, bottleneck_layers) -> List[Entry]:
    """reference lib/models/tiramisu.py:93-205 (segtpu torch_import.py:212-233)."""
    E: List[Entry] = [("conv", "firstconv", ("firstconv", "Conv_0"))]

    def dense(tp, fp, n):
        for j in range(n):
            E.append(("bn", f"{tp}.layers.{j}.norm", fp + (f"layer{j}", "norm")))
            E.append(("conv", f"{tp}.layers.{j}.conv", fp + (f"layer{j}", "conv", "Conv_0")))

    for i, n in enumerate(down_blocks):
        dense(f"denseBlocksDown.{i}", (f"denseDown{i}",), n)
        E.append(("bn", f"transDownBlocks.{i}.norm", (f"transDown{i}", "norm")))
        E.append(("conv", f"transDownBlocks.{i}.conv", (f"transDown{i}", "conv", "Conv_0")))
    dense("bottleneck.bottleneck", ("bottleneck",), bottleneck_layers)
    for i, n in enumerate(up_blocks):
        E.append(("deconv", f"transUpBlocks.{i}.convTrans",
                  (f"transUp{i}", "convTrans", "ConvTranspose_0")))
        dense(f"denseBlocksUp.{i}", (f"denseUp{i}",), n)
    E.append(("conv", "finalConv", ("finalConv", "Conv_0")))
    return E


# Where the GCN, PSPNet and DUC keep the ResNet's modules: layer0 = (conv1,
# bn1, ...); GCN's layer1 = (maxpool, layer1), hence ``layer1.1``.
def _layers_map(layer1: str = "layer1") -> Dict[str, str]:
    return {"conv1": "layer0.0", "bn1": "layer0.1", "layer1": layer1, "layer2": "layer2",
            "layer3": "layer3", "layer4": "layer4"}


def _entries_gcn(layers, bottleneck: bool) -> List[Entry]:
    """reference gcn152.py:64-167 (segtpu torch_import.py:236-248)."""
    E = _entries_resnet_encoder(_layers_map("layer1.1"), layers, bottleneck=bottleneck)
    for i in range(1, 5):
        for leg in ("conv_l1", "conv_l2", "conv_r1", "conv_r2"):
            E.append(("conv", f"gcm{i}.{leg}", (f"gcm{i}", leg, "Conv_0")))
    for i in range(1, 10):
        E.append(("conv", f"brm{i}.conv1", (f"brm{i}", "conv1", "Conv_0")))
        E.append(("conv", f"brm{i}.conv2", (f"brm{i}", "conv2", "Conv_0")))
    return E


def _entries_ppm(tp: str = "ppm", fp: Tuple[str, ...] = ("ppm",)) -> List[Entry]:
    """PSPNet's pyramid: bin i's conv and BatchNorm at ``features.{i}.1/.2``."""
    E: List[Entry] = []
    for idx, s in enumerate((1, 2, 3, 6)):
        E.append(("conv", f"{tp}.features.{idx}.1", fp + (f"conv_{s}", "Conv_0")))
        E.append(("bn", f"{tp}.features.{idx}.2", fp + (f"bn_{s}",)))
    return E


def _entries_psp() -> List[Entry]:
    """reference psp_net.py:42-96 (segtpu torch_import.py:251-265)."""
    E = _entries_resnet_encoder(_layers_map(), (3, 4, 23, 3), bottleneck=True)
    E += _entries_ppm()
    E += [
        ("conv", "final.0", ("final_conv", "Conv_0")),
        ("bn", "final.1", ("final_bn",)),
        ("conv", "final.4", ("final_cls", "Conv_0")),
        ("conv?", "aux_logits", ("aux_logits", "Conv_0")),
    ]
    return E


def _entries_duc_head(tp: str = "duc", fp: Tuple[str, ...] = ("duc",)) -> List[Entry]:
    return [("conv", f"{tp}.conv", fp + ("conv", "Conv_0")), ("bn", f"{tp}.bn", fp + ("bn",))]


def _entries_duc() -> List[Entry]:
    """reference duc_hdc.py:24-101 (segtpu torch_import.py:268-275)."""
    return (_entries_resnet_encoder(_layers_map(), (3, 8, 36, 3), bottleneck=True)
            + _entries_duc_head())


def _entries_linknext() -> List[Entry]:
    """reference linknext.py:227-278 over ResNeXt-26 2x64d, as segtpu fixes
    it (segtpu torch_import.py:278-318): decoder1's ``deconv2`` is a 3x3
    conv."""
    root = ("encoder",)
    E: List[Entry] = [
        ("conv", "encoder0.0", root + ("conv0", "Conv_0")),
        ("bn", "encoder0.1", root + ("bn0",)),
    ]
    for li in range(4):
        for b in range(2):
            tp, fp = f"encoder{li + 1}.{b}", root + (f"layer{li + 1}_{b}",)
            for kind, name in (("conv", "conv1_0"), ("bn", "bn1"), ("conv", "conv3_0"),
                               ("bn", "bn2"), ("conv", "conv1_1"), ("bn", "bn3")):
                E.append((kind, f"{tp}.basic.{name}",
                          fp + ((name, "Conv_0") if kind == "conv" else (name,))))
            E.append(("conv?", f"{tp}.shortcut.0", fp + ("shortcut", "Conv_0")))
            E.append(("bn", f"{tp}.bn0", fp + ("bn0",)))
    for i in range(1, 5):
        tp, fp = f"decoder{i}", (f"decoder{i}",)
        stride1 = i == 1
        E += [
            ("conv", f"{tp}.conv1", fp + ("conv1", "Conv_0")),
            ("bn", f"{tp}.norm1", fp + ("norm1",)),
            ("conv" if stride1 else "deconv", f"{tp}.deconv2",
             fp + ("deconv2", "Conv_0" if stride1 else "ConvTranspose_0")),
            ("bn", f"{tp}.norm2", fp + ("norm2",)),
            ("conv", f"{tp}.conv3", fp + ("conv3", "Conv_0")),
            ("bn", f"{tp}.norm3", fp + ("norm3",)),
        ]
    E += [
        ("deconv", "finaldeconv1", ("finaldeconv1", "ConvTranspose_0")),
        ("conv", "finalconv2", ("finalconv2", "Conv_0")),
        ("conv", "finalconv3", ("finalconv3", "Conv_0")),
    ]
    return E


def _entries_squeezenet() -> List[Entry]:
    """reference squeezenet.py:68-151 (segtpu torch_import.py:321-339)."""
    E: List[Entry] = [("conv", "conv1", ("conv1", "Conv_0"))]
    for i in range(2, 10):
        for leg in ("squeeze", "expand1x1", "expand3x3"):
            E.append(("conv", f"fire{i}.{leg}", (f"fire{i}", leg, "Conv_0")))
    E.append(("conv", "conv10.0", ("conv10", "Conv_0")))
    E.append(("conv", "dconv10.0", ("dconv10", "Conv_0")))
    for i in range(2, 10):
        for leg in ("expand1x1", "expand3x3", "squeeze"):
            E.append(("conv", f"dfire{i}.{leg}", (f"dfire{i}", leg, "Conv_0")))
    E.append(("conv", "dconv1", ("dconv1", "Conv_0")))
    return E


def identity_residual_entries(n_convs: int, tp: str = "",
                              fp: Tuple[str, ...] = ()) -> List[Entry]:
    """segtpu's ``IdentityResidualBlock`` at ``fp`` onto the port's at
    prefix ``tp`` (``"block."`` or ``""``): ``bn1``, ``bn2`` (and ``bn3``)
    are ABNs, whose BatchNorm segtpu names ``bn``; ``n_convs`` 2 or 3; the
    projection ``proj_conv`` where the block has one."""
    E: List[Entry] = [("bn", f"{tp}bn{i}", fp + (f"bn{i}", "bn")) for i in range(1, n_convs + 1)]
    E += [("conv", f"{tp}conv{i}", fp + (f"conv{i}", "Conv_0")) for i in range(1, n_convs + 1)]
    E.append(("conv?", f"{tp}proj_conv", fp + ("proj_conv", "Conv_0")))
    return E


def dense_module_entries(layers: int, tp: str = "", fp: Tuple[str, ...] = ()) -> List[Entry]:
    """segtpu's ``DenseModule`` of ``layers`` layers: ``bn1_i``/``bn3_i``
    (ABNs), ``conv1_i``/``conv3_i``."""
    E: List[Entry] = []
    for i in range(layers):
        for k in (1, 3):
            E.append(("bn", f"{tp}bn{k}_{i}", fp + (f"bn{k}_{i}", "bn")))
            E.append(("conv", f"{tp}conv{k}_{i}", fp + (f"conv{k}_{i}", "Conv_0")))
    return E


def wider_resnet_entries(depth: int = 28) -> List[Entry]:
    """segtpu's ``WideResNet`` (``layer{i}_{b}`` blocks) onto the port's
    (``layer{i}.{b}``); the 1x1 ``shortcut`` where a block has one."""
    E: List[Entry] = [("conv", "conv1", ("conv1", "Conv_0"))]
    for li in range(1, 4):
        for b in range((depth - 4) // 6):
            tp, fp = f"layer{li}.{b}", (f"layer{li}_{b}",)
            for k in (1, 2):
                E.append(("bn", f"{tp}.bn{k}", fp + (f"bn{k}",)))
                E.append(("conv", f"{tp}.conv{k}", fp + (f"conv{k}", "Conv_0")))
            E.append(("conv?", f"{tp}.shortcut", fp + ("shortcut", "Conv_0")))
    E += [("bn", "bn1", ("bn1",)), ("linear", "linear", ("linear",))]
    return E


_ENTRY_BUILDERS = {
    "linknet34": _entries_linknet34,
    "unet": _entries_unet,
    # segtpu's UNetABN keeps its UNet under "unet"; the reference's keys have no prefix
    "unet_abn": lambda: _entries_unet(root=("unet",), abn=True),
    "zf_unet": _entries_zf_unet,
    "unet11": lambda: _entries_ternaus(False),
    "unet16": lambda: _entries_ternaus(True),
    "albunet": _entries_albunet,
    "tiramisu57": lambda: _entries_tiramisu((4,) * 5, (4,) * 5, 4),
    "tiramisu67": lambda: _entries_tiramisu((5,) * 5, (5,) * 5, 5),
    "tiramisu103": lambda: _entries_tiramisu((4, 5, 7, 10, 12), (12, 10, 7, 5, 4), 15),
    "dilated_linknet34": _entries_dilated_linknet34,
    "gcn": lambda: _entries_gcn((3, 8, 36, 3), True),
    "gcn34": lambda: _entries_gcn((3, 4, 6, 3), False),
    "psp_net": _entries_psp,
    "duc": _entries_duc,
    "duc_dc": _entries_duc,
    "linknext": _entries_linknext,
    "squeezenet": _entries_squeezenet,
    # not in segtpu's registry: a classifier, WRN-28-10 (other depths:
    # state_dict_from_entries(wider_resnet_entries(depth), ...))
    "wider_resnet": wider_resnet_entries,
}


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
    for a name with no mapping and ``KeyError`` for a missing leaf."""
    name = model_name.lower()
    if name not in _ENTRY_BUILDERS:
        raise ValueError(f"no mapping for model {model_name!r}; "
                         f"mapped: {sorted(_ENTRY_BUILDERS)}")
    return state_dict_from_entries(_ENTRY_BUILDERS[name](), params, batch_stats)


def state_dict_from_entries(entries: List[Entry], params: Mapping,
                            batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """:func:`state_dict_from_jax` by a list of entries, for a model built
    at other than its registry's sizes (e.g. ``_entries_tiramisu`` of a
    narrow FCDenseNet)."""
    sd: Dict[str, torch.Tensor] = {}
    for kind, tp, path in entries:
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
        kernel = np.asarray(node["kernel"])
        # conv HWIO -> OIHW; deconv HWOI -> (in, out, kh, kw): same transpose;
        # dense (in, out) -> (out, in)
        sd[tp + ".weight"] = _tensor(kernel.T if kind == "linear"
                                     else np.transpose(kernel, (3, 2, 0, 1)))
        if "bias" in node:
            sd[tp + ".bias"] = _tensor(node["bias"])
    return sd


def jax_from_state_dict(model_name: str, state_dict: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict, Dict]:
    """The inverse of :func:`state_dict_from_jax`: segtpu's ``params`` and
    ``batch_stats`` trees (nested dicts of float32 numpy arrays, NHWC
    kernels) of ``model_name`` from a port ``state_dict``."""
    name = model_name.lower()
    if name not in _ENTRY_BUILDERS:
        raise ValueError(f"no mapping for model {model_name!r}; "
                         f"mapped: {sorted(_ENTRY_BUILDERS)}")
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaves):
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node.update(leaves)

    def arr(key):
        return state_dict[key].detach().cpu().float().numpy()

    for kind, tp, path in _ENTRY_BUILDERS[name]():
        optional = kind.endswith("?")
        kind = kind.rstrip("?")
        if tp + ".weight" not in state_dict:
            if optional:
                continue
            raise KeyError(tp + ".weight")
        if kind in ("bn", "abn"):
            put(params, path, {"scale": arr(tp + ".weight"), "bias": arr(tp + ".bias")})
            put(stats, path, {"mean": arr(tp + ".running_mean"), "var": arr(tp + ".running_var")})
            continue
        w = arr(tp + ".weight")
        leaves = {"kernel": np.ascontiguousarray(w.T if kind == "linear"
                                                 else np.transpose(w, (2, 3, 1, 0)))}
        if tp + ".bias" in state_dict:
            leaves["bias"] = arr(tp + ".bias")
        put(params, path, leaves)
    return params, stats
