"""``--encoder-weights`` (segtpu_torch/compat/encoder_weights.py) against
segtpu's ``install_encoder_weights``.

A random torchvision-format file (a ResNet's ``conv1/bn1/layerN`` with a
``fc`` head, or VGG ``features.N`` with a ``classifier``) goes into a model
whose other weights are segtpu's seeded tree, once through segtpu and once
through the port: every tensor of the two models is then equal, bit for bit,
for a basic-block ResNet (LinkNet34, AlbuNet, and LinkNet34 under ``-g``), a
bottleneck ResNet (PSPNet's ResNet-101) and VGG11/VGG16 (UNet11/UNet16), and
the parameters the file fills are those ``--freeze-encoder`` freezes in
both. LinkNet34's and UNet11's logits then match segtpu's (atol 3e-4). segtpu
trees come from ``jax.eval_shape`` with seeded values, nothing compiled but
the two forwards.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.compat.encoder_weights import encoder_paths, install_encoder_weights as jax_install
from segtpu.models import get_model as jax_get_model

from segtpu_torch import submit_cli, train_cli
from segtpu_torch.compat import encoder_weights
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.models import ENCODER_PREFIXES, get_model, without_encoder
from segtpu_torch.models.encoders.resnet import resnet34, resnet101
from segtpu_torch.train.checkpoint import save_snapshot

from torch_port_util import ATOL, _jax_variables, _nchw, _nhwc
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

VGG_WIDTHS = {"vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512),
              "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
                        512, 512, 512)}


def _randomised(sd, seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.dtype == torch.long:
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


def torchvision_file(path, arch, seed=0, in_channels=3):
    """A random torchvision-format ``.pth`` of ``arch``, with its head, saved
    wrapped in ``{"state_dict": ...}``."""
    if arch in VGG_WIDTHS:
        sd, cin, i = {}, in_channels, 0
        g = torch.Generator().manual_seed(seed)
        for w in VGG_WIDTHS[arch]:
            if w == "M":
                i += 1
                continue
            sd[f"features.{i}.weight"] = torch.randn((w, cin, 3, 3), generator=g) * 0.05
            sd[f"features.{i}.bias"] = torch.randn((w,), generator=g) * 0.05
            cin, i = w, i + 2
        sd["classifier.0.weight"] = torch.randn((4096, 25088 // 64), generator=g)
    else:
        enc = {"resnet34": resnet34, "resnet101": resnet101}[arch](num_channels=in_channels)
        sd = _randomised(enc.state_dict(), seed)
        sd["fc.weight"] = torch.zeros(1000, 2048 if arch == "resnet101" else 512)
        sd["fc.bias"] = torch.zeros(1000)
    torch.save({"state_dict": sd}, path)
    return path


CASES = {  # id: (model, torchvision arch, input channels)
    "linknet34": ("linknet34", "resnet34", 3),
    "linknet34_gray": ("linknet34", "resnet34", 1),
    "albunet": ("albunet", "resnet34", 3),
    "psp_net": ("psp_net", "resnet101", 3),
    "unet11": ("unet11", "vgg11", 3),
    "unet16": ("unet16", "vgg16", 3),
}


def _both(case, tmp_path):
    """(segtpu module and its installed (params, stats), the port model with
    the file installed, the port model before it)."""
    name, arch, channels = CASES[case]
    module = jax_get_model(name, num_channels=channels)
    params, stats = _jax_variables(module, (1, 64, 64, channels), seed=1)
    f = str(torchvision_file(tmp_path / "enc.pth", arch))
    new_params, new_stats = jax_install(name, params, stats, f)
    model = get_model(name, num_channels=channels, device="cpu")
    model.load_state_dict(state_dict_from_jax(name, params, stats))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    encoder_weights.install_encoder_weights(name, model, f)
    os.remove(f)
    return module, (jax.tree_util.tree_map(np.asarray, new_params),
                    jax.tree_util.tree_map(np.asarray, new_stats)), model, before, (params, stats)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_installs_what_segtpu_installs(case, tmp_path):
    """Every tensor equal to segtpu's after both load the same file; the
    tensors the file changed are the encoder's, which ``--freeze-encoder``
    freezes in the port and, through ``encoder_paths``, in segtpu."""
    name = CASES[case][0]
    _, (new_params, new_stats), model, before, (params, stats) = _both(case, tmp_path)
    want = state_dict_from_jax(name, new_params, new_stats)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    changed = {k for k, v in got.items() if not torch.equal(v, before[k])}
    params_changed = {k for k in changed if k in dict(model.named_parameters())}
    frozen = set(dict(model.named_parameters())) - without_encoder(
        name, {n for n, _ in model.named_parameters()})
    assert params_changed == frozen and len(frozen) > 10

    paths = encoder_paths(name, params)
    assert all(len(p) == 1 for p in paths)
    tops = {p[0] for p in paths}

    def fill(tree, flag):
        return {k: fill(v, flag) if isinstance(v, dict) else np.full(np.shape(v), flag, np.float32)
                for k, v in tree.items()}

    flags = state_dict_from_jax(name, {k: fill(v, k in tops) for k, v in params.items()},
                                {k: fill(v, k in tops) for k, v in stats.items()})
    names = set(dict(model.named_parameters()))
    assert {k for k in names if bool(flags[k].all())} == frozen
    assert all(k.startswith(ENCODER_PREFIXES[name]) for k in changed)


@pytest.mark.parametrize("case", ["linknet34", "unet11"])
def test_logits_match_segtpu_after_the_encoder_weights(case, tmp_path):
    """The forward of both models (eval mode) on the same seeded 64 x 64
    batch, atol 3e-4."""
    module, (params, stats), model, _, _ = _both(case, tmp_path)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = np.asarray(jax.jit(lambda v, a: module.apply(v, a, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    model.eval()
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_first_conv_takes_the_rgb_sum_under_grayscale(tmp_path):
    """A 3-channel stem into a 1-channel model: the sum over RGB, as
    segtpu's; any other shape mismatch is refused."""
    model = get_model("linknet34", num_channels=1, device="cpu")
    f = str(torchvision_file(tmp_path / "a.pth", "resnet34"))
    encoder_weights.install_encoder_weights("linknet34", model, f)
    want = torch.load(f)["state_dict"]["conv1.weight"].sum(1, keepdim=True)
    assert torch.equal(model.firstconv.weight.detach(), want)
    sd = torch.load(f)
    sd["state_dict"]["layer1.0.conv1.weight"] = torch.zeros(64, 64, 1, 1)
    torch.save(sd, tmp_path / "b.pth")
    with pytest.raises(ValueError, match="does not match"):
        encoder_weights.install_encoder_weights("linknet34", model, str(tmp_path / "b.pth"))


def test_unwrap_and_refusals(tmp_path):
    """A raw state_dict, ``{"model": ...}`` and ``{"state_dict": ...}`` load
    alike; a model without an encoder spec and a file of another
    architecture are refused."""
    sd = torch.load(torchvision_file(tmp_path / "a.pth", "resnet34"))["state_dict"]
    assert encoder_weights.unwrap_state_dict(sd) is sd
    assert encoder_weights.unwrap_state_dict({"model": sd}) is sd
    with pytest.raises(KeyError, match="takes no pretrained encoder weights"):
        encoder_weights.encoder_state_dict("squeezenet", sd)
    torchvision_file(tmp_path / "v.pth", "vgg11")
    with pytest.raises(KeyError, match="wrong architecture"):
        encoder_weights.install_encoder_weights("linknet34", get_model("linknet34", device="cpu"),
                                                str(tmp_path / "v.pth"))
    with pytest.raises(KeyError, match="wrong architecture"):
        encoder_weights.install_encoder_weights(
            "psp_net", get_model("psp_net", device="cpu"),
            str(torchvision_file(tmp_path / "r34.pth", "resnet34")))


def test_clis_take_encoder_weights(tmp_path, monkeypatch):
    """``train_cli --encoder-weights`` loads the file before training;
    ``submit_cli --encoder-weights`` before the checkpoint, which wins."""
    f = str(torchvision_file(tmp_path / "enc.pth", "resnet34", seed=4))
    seen = []
    train_cli.main(["-m", "linknet34", "-d", "shapes", "-b", "2", "-p", "64", "-s", "1", "-e", "0",
                    "--device", "cpu", "--no-tensorboard", "--experiments-dir", str(tmp_path),
                    "--encoder-weights", f],
                   model_initializer=lambda m, a: seen.append(m.state_dict()))
    want = torch.load(f)["state_dict"]["layer4.2.conv2.weight"]
    assert torch.equal(seen[0]["encoder4.2.conv2.weight"], want)

    loaded = []
    real = encoder_weights.install_encoder_weights
    monkeypatch.setattr(submit_cli, "install_encoder_weights",
                        lambda *a: (real(*a), loaded.append(a[1].firstconv.weight.detach().clone())))
    model = get_model("linknet34", device="cpu", seed=6)
    save_snapshot(str(tmp_path / "c.pth"), model)
    (tmp_path / "data" / "images").mkdir(parents=True)
    submit_cli.main(["-m", "linknet34", "-c", str(tmp_path / "c.pth"), "-p", "64", "-b", "8",
                     "-dd", str(tmp_path / "data"), "--device", "cpu", "--encoder-weights", f,
                     "--submits-dir", str(tmp_path / "s")])
    assert torch.equal(loaded[0], torch.load(f)["state_dict"]["conv1.weight"])
    assert not torch.equal(loaded[0], model.firstconv.weight.detach())
