"""The port's CLIs as several ranks on the CPU (gloo), started the way
``torchrun`` starts them: the launcher variables set, one process per rank.

* ``train_cli`` data parallel: two ranks of 2 samples each against one
  process on the same global batch of 4 (losses and IoU rtol 1e-5 per
  epoch, thresholded accuracy atol 1e-3; fp32);
  only rank 0 writes; its checkpoint loads in one process.
* ``train_cli --model-parallel 2``: against one process, the same gates; the
  checkpoint holds the full weights and Adam moments, loads in one process,
  and ``-r`` under two ranks cuts them again and trains on.
* ``submit_cli --tile-parallel``: two ranks write the one-process masks.
* The bootstrap: no launcher variables, no process group; some of them only,
  an error.
"""

import shutil

import numpy as np
import pytest
import torch

from segtpu_torch import submit_cli, train_cli
from segtpu_torch.models import get_model
from segtpu_torch.parallel import distributed
from segtpu_torch.train.checkpoint import read_snapshot, save_snapshot

from torch_port_util import run_ranks
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

CLI_RTOL = 1e-5
# data parallel trains with SGD: Adam's first steps move each weight by about
# lr whatever its gradient's size, so fp32 rounding in a near-zero gradient (a
# conv bias that feeds a BatchNorm) moves the loss by ~1e-4 between two
# summation orders of the batch; model parallel keeps the batch's order
OPTIMIZERS = {"sgd": ("-o", "sgd", "-lr", "1e-2"), "adam": ("-o", "adam", "-lr", "1e-3")}


def _train_args(exp, *extra, epochs=1):
    return ["-m", "linknet34", "-d", "shapes", "-l", "bce_jaccard", "-b", "4", "-p", "64", "-s", "2", "-e", str(epochs), "--seed", "3", "--device", "cpu",
            "--no-tensorboard", "--experiments-dir", str(exp), *extra]


def _exp_dir(exp):
    return exp / "shapes" / "bce_jaccard" / "shapes_linknet34_64_rgb_bce_jaccard"


def _history(exp):
    import csv
    with open(_exp_dir(exp) / "shapes_linknet34_64_rgb_bce_jaccard.csv") as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


def _ranks_train(exp, *extra, epochs=1):
    return run_ranks(["-m", "segtpu_torch.train_cli", *_train_args(exp, *extra, epochs=epochs)])


# thresholded accuracy counts pixels: one whose probability sits within fp32
# rounding of 0.5 may flip (1 pixel of a 4 x 64 x 64 batch is 6.1e-5)
ACCURACY_ATOL = 1e-3


def _assert_close_history(got, want, rtol=CLI_RTOL):
    """Losses and soft IoU to ``rtol``, accuracies to atol 1e-3."""
    assert list(got) == list(want) and got["epoch"] == want["epoch"]
    for k in want:
        if k.endswith("accuracy"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ACCURACY_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def one_process(module_tmp):
    """The one-process histories of two epochs, by optimizer."""
    out = {}
    for name, flags in OPTIMIZERS.items():
        history = train_cli.main(_train_args(module_tmp(name), *flags,
                                             "--snapshot-every", "0", epochs=2))
        out[name] = {k: [float(v) for v in vs] for k, vs in history.items()}
    return out


def test_train_cli_data_parallel_equals_one_process(one_process, tmp_path):
    """Two ranks over the global batch: the one-process history to rtol
    1e-5; rank 0 alone prints the epochs and writes the files; the
    checkpoint loads strictly into a one-process model."""
    outs = _ranks_train(tmp_path, *OPTIMIZERS["sgd"], epochs=2)
    _assert_close_history(_history(tmp_path), one_process["sgd"])
    assert "Ranks          2 (data 2 x model 1)" in outs[0] and "Ranks" not in outs[1]
    assert "Training is finished" in outs[0] and "Training is finished" not in outs[1]
    ckpt = read_snapshot(str(_exp_dir(tmp_path) / "linknet34_checkpoint.pth"))
    get_model("linknet34", device="cpu").load_state_dict(ckpt["model"])
    assert len((_exp_dir(tmp_path) / "shapes_linknet34_64_rgb_bce_jaccard.csv")
               .read_text().splitlines()) == 3
    shutil.rmtree(tmp_path / "shapes")


def test_train_cli_model_parallel_checkpoint_and_resume(one_process, tmp_path):
    """``--model-parallel 2``: epoch 0 equals one process's to rtol 1e-5;
    its checkpoint holds the full weights and full-shaped Adam moments
    (one-process shapes) and loads in one process; ``-e 2 -r`` under two
    ranks restores it, cut again, and its epoch 1 equals the one-process
    run's to rtol 1e-4 (four Adam steps in fp32)."""
    _ranks_train(tmp_path, "--model-parallel", "2", *OPTIMIZERS["adam"])
    ckpt = read_snapshot(str(_exp_dir(tmp_path) / "linknet34_checkpoint.pth"))
    model = get_model("linknet34", device="cpu")
    model.load_state_dict(ckpt["model"])
    names = [n for n, _ in model.named_parameters()]
    shapes = dict(model.named_parameters())
    for i, state in ckpt["optimizer"]["state"].items():
        assert state["exp_avg"].shape == state["exp_avg_sq"].shape == shapes[names[i]].shape
    want = one_process["adam"]
    _assert_close_history({k: v[:1] for k, v in _history(tmp_path).items()},
                          {k: v[:1] for k, v in want.items()})
    _ranks_train(tmp_path, "--model-parallel", "2", "-r", *OPTIMIZERS["adam"], epochs=2)
    # the resumed run appends its whole history (the restored epoch 0, then
    # 1); after four Adam steps in fp32 the gate is rtol 1e-4
    _assert_close_history({k: v[-1:] for k, v in _history(tmp_path).items()},
                          {k: v[-1:] for k, v in want.items()}, rtol=1e-4)
    shutil.rmtree(tmp_path / "shapes")


def test_train_cli_s2d_under_model_parallel_equals_one_process(tmp_path):
    """``--s2d --model-parallel 2`` (LinkNet34's head in s2d form at 65 x
    65, its encoder's and decoder's wide layers sharded): the epoch equals
    the one-process ``--s2d`` run's to rtol 1e-5."""
    want = train_cli.main(_train_args(tmp_path / "one", "--s2d", *OPTIMIZERS["sgd"]))
    _ranks_train(tmp_path / "ranks", "--s2d", "--model-parallel", "2", *OPTIMIZERS["sgd"])
    _assert_close_history(_history(tmp_path / "ranks"),
                          {k: [float(v) for v in vs] for k, vs in want.items()})


def test_train_cli_rejects_a_batch_that_does_not_split(tmp_path):
    """``-b 3`` over two data ranks: rank count and batch do not fit."""
    with pytest.raises(AssertionError, match="does not split over 2 data ranks"):
        run_ranks(["-m", "segtpu_torch.train_cli",
                   *_train_args(tmp_path, *OPTIMIZERS["sgd"], "-b", "3", "-s", "1")])


def test_submit_cli_tile_parallel_writes_the_one_process_masks(tmp_path):
    """Two ranks with ``--tile-parallel`` write the masks one process writes
    (rank 0 writes; thresholded probabilities within 1e-4 of each other)."""
    import cv2

    rng = np.random.RandomState(4)
    (tmp_path / "data" / "images").mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(tmp_path / "data" / "images" / f"img{i}.tif"),
                    rng.randint(0, 256, (100, 90, 3)).astype(np.uint8))
    model = get_model("linknet34", device="cpu", seed=5)
    save_snapshot(str(tmp_path / "ckpt.pth"), model, epoch=0, loss=1.0)
    common = ["-m", "linknet34", "-c", str(tmp_path / "ckpt.pth"), "-p", "64", "-b", "16",
              "-dd", str(tmp_path / "data"), "--device", "cpu"]
    submit_cli.main(common + ["--submits-dir", str(tmp_path / "one")])
    outs = run_ranks(["-m", "segtpu_torch.submit_cli", *common, "--tile-parallel",
                      "--submits-dir", str(tmp_path / "two")])
    assert "2/2 img1" in outs[0] and "img1" not in outs[1]
    for i in range(2):
        name = f"inria_linknet34_64_rgb/img{i}.tif"
        one = cv2.imread(str(tmp_path / "one" / name), cv2.IMREAD_UNCHANGED)
        two = cv2.imread(str(tmp_path / "two" / name), cv2.IMREAD_UNCHANGED)
        assert one.shape == (100, 90) and np.array_equal(one, two)


def test_launch_variables(monkeypatch):
    """No launcher variable: a single run, no process group. Some but not
    all: an error, not a silent single run."""
    for v in distributed.LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    assert distributed.maybe_initialize_distributed("cpu") is False
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="are not"):
        distributed.maybe_initialize_distributed("cpu")


_SHAPES_RUN = ["-m", "linknet34", "-d", "shapes", "-b", "2", "-p", "64", "-e", "1", "-s", "1",
               "--no-tensorboard"]


@pytest.mark.parametrize("module, argv", [
    ("train_cli", ["-m", "linknet34", "-d", "shapes", "--model-parallel", "1"]),
    ("submit_cli", ["-m", "linknet34", "-c", "x.pth", "--tile-parallel"]),
    ("profile_reduce", []), ("profile_serve", []), ("profile_train", []),
    ("train_ab_cli", _SHAPES_RUN), ("train_reg_cli", _SHAPES_RUN),
    ("bench", ["--config", "zf_unet-512"]),
    ("lr_finder", ["-m", "linknet34", "-d", "shapes", "-b", "2", "-p", "64"]),
    ("ab_nuclei", ["--work", "work"]), ("ab_ladder", ["--phase", "l0", "--work", "work"]),
    ("roofline", ["--config", "zf_unet-512"]), ("tiled_floor", []), ("bn_sol", [])])
def test_entry_points_resolve_the_device(module, argv, tmp_path, monkeypatch):
    """Without a GPU every entry point raises the port's device error, unless
    the caller asks for the CPU: no silent switch, the parallel flags too."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for v in distributed.LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(f"segtpu_torch.{module}").main(argv)


def test_submit_cli_s2d_serves_in_s2d_form(tmp_path, monkeypatch):
    """``--s2d`` sets the s2d form of a model that has one (LinkNet34's
    head) before the checkpoint loads; the dilated LinkNet34 has none and
    exits with segtpu's message."""
    seen = []

    def stop(model, *args, **kwargs):
        seen.append(model.s2d)
        raise SystemExit("stop")

    monkeypatch.setattr(submit_cli, "auto_file", lambda path: path)
    monkeypatch.setattr(submit_cli, "load_checkpoint", stop)
    with pytest.raises(SystemExit, match="stop"):
        submit_cli.main(["-m", "linknet34", "-c", "x.pth", "--s2d", "--device", "cpu",
                         "--submits-dir", str(tmp_path / "s")])
    assert seen == [True]
    with pytest.raises(SystemExit, match="--s2d: model 'dilated_linknet34' has no s2d mode"):
        submit_cli.main(["-m", "dilated_linknet34", "-c", "x.pth", "--s2d", "--device", "cpu",
                         "--submits-dir", str(tmp_path / "s")])
