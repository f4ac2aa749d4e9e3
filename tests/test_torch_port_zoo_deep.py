"""segtpu_torch's full-depth zoo models (GCN152, PSPNet, DUC and DUC-HDC over
ResNet-101/152) and the zoo's entry points, without JAX compute: segtpu's
trees come from ``jax.eval_shape``, so nothing of segtpu is compiled or run
(segtpu marks its own ResNet-101/152 tests slow).

* the weight mapping against segtpu's exporter, key for key and leaf for
  leaf, loaded with ``strict=True``, with segtpu's parameter count;
* a port-only forward of each at 1 x 3 x 64 x 64 (finite fp32 logits of
  the input's size);
* every one of segtpu's 18 registry names builds, seeded, on the CPU when
  asked, and raises without a GPU otherwise;
* ``--freeze-encoder``'s set is segtpu's encoder subtree, key for key;
  SqueezeNet has none and the CLI exits;
* the BatchNorm counts and the pyramid's shapes that ``profile_reduce``
  records;
* the train CLI, ``measure_train`` and the submit CLI on new models.

Full width, 64 x 64, fp32 on the CPU, the kernels through their plain
versions, torch on two threads.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segtpu.compat.encoder_weights import encoder_paths
from segtpu.compat.torch_import import export_state_dict
from segtpu.models import get_model as jax_get_model
from segtpu.models import model_names as jax_model_names
from segtpu.utils import count_parameters as jax_count_parameters

from segtpu_torch import submit_cli, train_cli
from segtpu_torch.bench import measure_train
from segtpu_torch.compat.jax_params import state_dict_from_jax
from segtpu_torch.models import ENCODER_PREFIXES, get_model, model_names, without_encoder
from segtpu_torch.profile_reduce import NORM_LAYERS, step_norm_shapes
from segtpu_torch.train.checkpoint import load_snapshot, save_snapshot
from segtpu_torch.utils import count_parameters

from torch_port_util import _numpy_dicts
from torch_port_util import tmp_path  # noqa: F401  (removed after use)

DEEP = ["gcn", "psp_net", "duc", "duc_dc"]
NEW = ["dilated_linknet34", "gcn", "gcn34", "psp_net", "duc", "duc_dc", "linknext", "squeezenet"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _indexed_tree(name):
    """segtpu's tree of ``name`` by ``jax.eval_shape``, leaf k filled with
    the value k: ``(params, batch_stats, number of leaves)``."""
    tree = jax.eval_shape(lambda: jax_get_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tree = _numpy_dicts(jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, k, np.float32) for k, s in enumerate(leaves)]))
    return tree["params"], tree.get("batch_stats", {}), len(leaves)


@pytest.mark.parametrize("name", NEW)
def test_state_dict_from_jax_maps_every_segtpu_leaf_once(name):
    """The same keys and arrays as segtpu's exporter, plus a
    ``num_batches_tracked`` of 0 for each BatchNorm; each of segtpu's
    leaves (leaf k filled with k) lands in exactly one tensor of its
    shape; the registry's model loads the result with ``strict=True``."""
    params, stats, n_leaves = _indexed_tree(name)
    ours = state_dict_from_jax(name, params, stats)
    theirs = export_state_dict(name, params, stats)
    tracked = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - tracked == set(theirs) and len(tracked) == NORM_LAYERS[name][0]
    assert all(int(ours[k]) == 0 for k in tracked)
    values = []
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
        assert bool((ours[k] == ours[k].flatten()[0]).all()), k
        values.append(int(ours[k].flatten()[0]))
    assert sorted(values) == list(range(n_leaves))
    model = get_model(name, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert count_parameters(model) == jax_count_parameters(params)


@pytest.mark.parametrize("name", DEEP)
def test_deep_model_forward_on_cpu(name):
    """1 x 3 x 64 x 64 through the full-depth model in eval mode: finite
    fp32 logits of the input's size, the same for the same seed."""
    model = get_model(name, device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(1).normal(0.0, 1.0, (1, 3, 64, 64))
                         .astype(np.float32))
    with torch.no_grad():
        out = model(x)
        again = get_model(name, device="cpu", seed=3)(x)
    assert out.shape == (1, 1, 64, 64) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(out.std()) > 0
    assert torch.equal(out, again)


def test_registry_has_every_segtpu_name():
    assert model_names() == jax_model_names() and len(model_names()) == 18


@pytest.mark.parametrize("name", NEW)
def test_get_model_runs_on_cuda_unless_the_cpu_is_asked_for(name, monkeypatch):
    model = get_model(name, device="cpu", seed=4)
    assert not model.training and next(model.parameters()).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(name)


@pytest.mark.parametrize("name", NEW)
def test_freeze_encoder_set_is_segtpu_encoder_subtree(name):
    """The parameters that ``--freeze-encoder`` freezes are the tensors
    that segtpu's encoder subtree (``encoder_paths``) maps to, key for key:
    segtpu's tree with its encoder leaves set to 1 and every other leaf 0,
    through the port's mapping. SqueezeNet has no encoder subtree on either
    side."""
    tree = jax.eval_shape(lambda: jax_get_model(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tree = _numpy_dicts(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree))
    params, stats = tree["params"], tree.get("batch_stats", {})
    paths = encoder_paths(name, params)
    model = get_model(name, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    if name == "squeezenet":
        assert paths == ()
        with pytest.raises(ValueError, match="no encoder"):
            without_encoder(name, names)
        return
    for path in paths:
        node = params
        for key in path:
            node = node[key]
        jax.tree_util.tree_map(lambda a: a.fill(1.0), node)
    sd = state_dict_from_jax(name, params, stats)
    want = {k for k in names if bool((sd[k] == 1.0).all())}
    assert want and all(bool((sd[k] == 0.0).all()) for k in names - want)
    assert names - without_encoder(name, names) == want
    assert all(k.startswith(ENCODER_PREFIXES[name]) for k in want)


def test_profile_reduce_records_the_zoo_norm_shapes():
    """The BatchNorm counts of each new model's step (NORM_LAYERS, checked
    by ``step_norm_shapes``' hooks) and PSPNet's pyramid: four BatchNorms
    over 512 channels of 1 x 1, 2 x 2, 3 x 3 and 6 x 6 at 64 x 64 / 8."""
    counts = {}
    for name in NEW:
        shapes = step_norm_shapes(2, 64, device="cpu", model_name=name)
        counts[name] = (len(shapes["bn"]), len(shapes["abn"]))
        if name == "psp_net":
            assert shapes["bn"][-5:-1] == [(2, 512, s, s) for s in (1, 2, 3, 6)]
            assert shapes["bn"][-1] == (2, 512, 8, 8)
        if name in ("psp_net", "duc", "duc_dc"):
            assert (2, 2048, 8, 8) in shapes["bn"]
    assert counts == {n: NORM_LAYERS[n] for n in NEW}
    assert counts["psp_net"] == (104 + 4 + 1, 0) and counts["duc"] == (155 + 1, 0)


def _cli(exp_dir, model, *extra):
    return ["-m", model, "-d", "shapes", "-l", "bce", "-o", "sgd", "-lr", "1e-3", "-b", "2",
            "-p", "64", "-s", "1", "-e", "1", "--device", "cpu", "--no-tensorboard",
            "--seed", "0", "--experiments-dir", str(exp_dir), *extra]


def test_train_cli_trains_psp_net(tmp_path):
    history = train_cli.main(_cli(tmp_path, "psp_net"))
    assert history["epoch"] == [0]
    assert all(math.isfinite(v) for v in history["loss"] + history["val_loss"])
    run = tmp_path / "shapes" / "bce" / "shapes_psp_net_64_rgb_bce"
    after, _ = load_snapshot(str(run / "psp_net_snapshot.pth"))
    # the pyramid's BatchNorms took the batch's statistics at momentum 0.95
    assert int(after["ppm.features.0.2.num_batches_tracked"]) == 1
    assert not torch.equal(after["ppm.features.3.2.running_var"], torch.ones(512))


def test_train_cli_freeze_encoder_on_dilated_linknet34(tmp_path):
    """One epoch with the encoder frozen: every encoder parameter in the
    .pth keeps its initial value, the head moves."""
    train_cli.main(_cli(tmp_path, "dilated_linknet34", "--freeze-encoder"))
    run = tmp_path / "shapes" / "bce" / "shapes_dilated_linknet34_64_rgb_bce"
    after, _ = load_snapshot(str(run / "dilated_linknet34_snapshot.pth"))
    initial = get_model("dilated_linknet34", device="cpu")
    before = initial.state_dict()
    frozen = [n for n, _ in initial.named_parameters()
              if n.startswith(ENCODER_PREFIXES["dilated_linknet34"])]
    assert len(frozen) == 108 and all(torch.equal(after[n], before[n]) for n in frozen)
    assert not torch.equal(after["finalconv3.weight"], before["finalconv3.weight"])


def test_train_cli_freeze_encoder_exits_for_squeezenet(tmp_path):
    with pytest.raises(SystemExit, match="no encoder"):
        train_cli.main(_cli(tmp_path, "squeezenet", "--freeze-encoder"))


@pytest.mark.parametrize("name", ["gcn34", "linknext"])
def test_measure_train_runs_new_models_on_cpu(name):
    ips = measure_train(batch_size=2, patch=64, steps=1, warmup=1, model_name=name,
                        bf16=False, loss_name="bce", optimizer="sgd", device="cpu")
    assert math.isfinite(ips) and ips > 0


def test_submit_cli_runs_dilated_linknet34(tmp_path, monkeypatch):
    """The submit CLI on a DilatedLinkNet34 snapshot over one 80 x 72 image
    at patch 64: a 0/255 mask of the image's size."""
    import cv2

    data = tmp_path / "data" / "images"
    data.mkdir(parents=True)
    image = np.random.RandomState(8).randint(0, 256, (80, 72, 3)).astype(np.uint8)
    cv2.imwrite(str(data / "tile1.png"), image[..., ::-1])
    model = get_model("dilated_linknet34", device="cpu")
    save_snapshot(str(tmp_path / "dilated_linknet34_checkpoint.pth"), model, epoch=1, loss=0.5,
                  train_history={}, args="test")
    monkeypatch.chdir(tmp_path)
    submit_cli.main(["-m", "dilated_linknet34", "-c", "dilated_linknet34_checkpoint.pth",
                     "-p", "64", "-b", "8", "-dd", str(tmp_path / "data"), "--submits-dir",
                     "port", "--device", "cpu"])
    mask = cv2.imread(str(tmp_path / "port" / "inria_dilated_linknet34_64_rgb" / "tile1.tif"),
                      cv2.IMREAD_GRAYSCALE)
    assert mask.shape == (80, 72) and set(np.unique(mask)) <= {0, 255}
