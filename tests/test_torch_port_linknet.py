"""segtpu_torch's LinkNet34 against segtpu's, with the same weights carried
across by ``state_dict_from_jax``; the port's registry, device rule and
checkpoint format."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segtpu.compat.torch_import import export_state_dict

from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.models import get_model
from segtpu_torch.train.checkpoint import load_snapshot, save_snapshot

from torch_port_util import jax_linknet34, port_linknet34
from torch_port_util import tmp_path  # noqa: F401  (removed after use)


@pytest.fixture(scope="module")
def linknet():
    module, params, stats = jax_linknet34(seed=0)
    return module, params, stats, port_linknet34(params, stats)


def test_linknet34_eval_logits_match_segtpu(linknet):
    module, params, stats, model = linknet
    x = np.random.RandomState(3).normal(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(module.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 64, 64)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=3e-4)


def test_linknet34_parameter_counts_match(linknet):
    _, params, _, model = linknet
    n_jax = sum(int(np.prod(np.shape(v))) for v in _leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_state_dict_from_jax_equals_export_state_dict(linknet):
    """Cross-check against segtpu's own exporter. segtpu keeps no
    num_batches_tracked; the port fills it with 0 for each plain BatchNorm."""
    _, params, stats, model = linknet
    ours = state_dict_from_jax("linknet34", params, stats)
    theirs = export_state_dict("linknet34", params, stats)
    tracked = {k for k in ours if k.endswith(".num_batches_tracked")}
    assert set(ours) - tracked == set(theirs)
    assert set(ours) == set(model.state_dict())
    assert all(int(ours[k]) == 0 for k in tracked)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


# segtpu's WiderResNet (models/wider_resnet.py) is ported but, as in segtpu,
# not in the registry: state_dict_from_jax maps it, get_model refuses it.
def test_state_dict_from_jax_rejects_unported_model():
    """``"wider_resnet"`` maps segtpu's WRN-28 tree leaf for leaf onto the
    port's WideResNet (each leaf used once, transposed as its kind says); a
    name with no mapping raises."""
    from segtpu.models.wider_resnet import WideResNet as JaxWideResNet
    from segtpu_torch.models.wider_resnet import WideResNet
    from torch_port_util import _jax_variables

    params, stats = _jax_variables(JaxWideResNet(depth=28, widen_factor=2), (1, 8, 8, 3))
    sd = state_dict_from_jax("wider_resnet", params, stats)
    model = WideResNet(depth=28, widen_factor=2)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    leaves = [np.asarray(a) for tree in (params, stats) for a in _leaves(tree)]
    used = [v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")]
    # 25 BatchNorms x 4, 25 convs x 2 (kernel, bias), 3 shortcuts x 2, the linear's 2
    assert len(used) == len(leaves) == 25 * 4 + 25 * 2 + 3 * 2 + 2
    assert sorted(a.size for a in used) == sorted(a.size for a in leaves)
    np.testing.assert_array_equal(sd["linear.weight"].numpy(), params["linear"]["kernel"].T)
    np.testing.assert_array_equal(sd["layer2.0.shortcut.weight"].numpy(),
                                  params["layer2_0"]["shortcut"]["Conv_0"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["layer3.3.bn2.running_var"].numpy(),
                                  stats["layer3_3"]["bn2"]["var"])
    with pytest.raises(ValueError, match="no mapping for model 'wider_resnet_50'"):
        state_dict_from_jax("wider_resnet_50", {}, {})


def test_no_source_of_the_port_imports_jax_or_segtpu():
    """The import lines themselves, in the text of every source of the port
    and of chip_smoke.py (the test above sees only what the modules load)."""
    root = Path(__file__).resolve().parent.parent
    sources = sorted((root / "segtpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(sources) > 50
    pattern = re.compile(r"^\s*(import|from) (jax|segtpu)(\.| |$)")
    bad = [f"{p.relative_to(root)}:{i}" for p in sources
           for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.match(line)]
    assert not bad, bad


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_get_model_rejects_unported_model():
    """segtpu's registry does not name wider_resnet; neither does the port's."""
    from segtpu.models import get_model as jax_get_model
    with pytest.raises(ValueError, match="wider_resnet"):
        jax_get_model("wider_resnet")
    with pytest.raises(ValueError, match="no model 'wider_resnet' in the registry"):
        get_model("wider_resnet", device="cpu")


def test_get_model_without_device_raises_on_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("linknet34")


def test_get_model_is_seeded():
    a = get_model("linknet34", device="cpu", seed=5).state_dict()
    b = get_model("linknet34", device="cpu", seed=5).state_dict()
    c = get_model("linknet34", device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["firstconv.weight"], c["firstconv.weight"])


def test_snapshot_roundtrip(tmp_path, linknet):
    model = linknet[3]
    path = tmp_path / "linknet34_checkpoint.pth"
    save_snapshot(str(path), model, epoch=3, loss=0.25, train_history={"loss": [1.0]},
                  args="-m linknet34")
    state_dict, meta = load_snapshot(str(path))
    assert meta == {"epoch": 3, "loss": 0.25, "train_history": {"loss": [1.0]},
                    "args": "-m linknet34"}
    ref = model.state_dict()
    assert set(state_dict) == set(ref)
    assert all(torch.equal(state_dict[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="unknown snapshot fields"):
        save_snapshot(str(path), model, scheduler={})


def port_modules():
    """Every module of segtpu_torch, found by walking the package."""
    import segtpu_torch
    return ["segtpu_torch"] + sorted(m.name for m in pkgutil.walk_packages(
        segtpu_torch.__path__, "segtpu_torch."))


def test_port_imports_neither_jax_nor_segtpu():
    """Nor scikit-learn, which the card's machine does not have; nor does
    chip_smoke.py."""
    modules = port_modules()
    assert {"segtpu_torch.profile_reduce", "segtpu_torch.train_cli",
            "segtpu_torch.data.pipeline", "segtpu_torch.models.unet",
            "segtpu_torch.models.afterburner_stack", "segtpu_torch.train_ab_cli",
            "segtpu_torch.data.split", "segtpu_torch.data.dsb2018",
            "segtpu_torch.ab_nuclei"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})\n"
        f"for m in {modules + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'segtpu', 'sklearn'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
