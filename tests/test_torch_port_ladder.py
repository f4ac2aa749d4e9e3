"""The port's LinkNet34 ladder (segtpu_torch.ab_ladder) on the CPU.

Its switches (no geometric augmentation, sequential loaders, dropout at
p = 0) act on the train CLI and are undone after each leg; two 1-epoch L0
legs at a tiny size give the same CSV bit for bit, while dropout on draws
the step-keyed masks; the report renders the committed results/ab_ladder/
CSVs; the port's Dropout2d draws masks with the statistics of segtpu's
(the ladder's dropout bisect). One intra-op thread: CPU reductions split by
thread count are not repeatable under the loader's threads.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu.models.layers import Dropout2d as JaxDropout2d

from segtpu_torch import ab_ladder, ab_nuclei, train_cli
from segtpu_torch.data import dsb2018
from segtpu_torch.data.pipeline import DataLoader
from segtpu_torch.models.layers import Dropout2d
from segtpu_torch.ops import abn as abn_ops
from torch_port_util import module_tmp, tmp_path  # noqa: F401  (removed after use)

TINY = dict(patch=64, batch=2, images=2, device="cpu", steps=1)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _patched():
    return (dsb2018._heavy_geometric, train_cli.DataLoader, train_cli.get_model,
            abn_ops._on_device)


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


def test_switches_act_on_the_cli_and_are_undone():
    before = _patched()
    with ab_ladder.ladder_switches(dropout=False, plain_norm=True):
        assert dsb2018._heavy_geometric() == []
        model = train_cli.get_model("linknet34", patch_size=64, device="cpu")
        assert model.finaldrop1.p == 0.0
        assert abn_ops._on_device is not before[3]
        samples = [(np.full((1, 1, 1), i, np.float32), np.zeros((1, 1, 1), np.float32))
                   for i in range(10)]
        loader = train_cli.DataLoader(samples, batch_size=2, shuffle=True, workers=2,
                                      drop_last=True, seed=3)
        assert [int(v) for x, _ in loader for v in x.ravel()] == list(range(10))
        shuffled = DataLoader(samples, batch_size=2, shuffle=True, workers=2, seed=3)
        assert [int(v) for x, _ in shuffled for v in x.ravel()] != list(range(10))
    assert _patched() == before
    assert [type(t).__name__ for t in dsb2018._heavy_geometric()] == [
        "RandomRotate90", "VerticalFlip", "HorizontalFlip", "ShiftScaleRotate"]
    with ab_ladder.ladder_switches(dropout=True):
        assert train_cli.get_model("linknet34", patch_size=64, device="cpu").finaldrop1.p == 0.5
        assert abn_ops._on_device is before[3]
    assert _patched() == before


def test_run_leg_restores_everything_after_a_failing_leg():
    before, flags = _patched(), _flags()
    seen = {}

    def failing(argv):
        seen.update(flags=_flags(), argv=argv)
        raise RuntimeError("leg fails")

    with pytest.raises(RuntimeError, match="leg fails"):
        ab_ladder.run_leg(["-e", "1"], dropout=False, tf32=True, train=failing)
    assert seen["flags"] == (True, True, True)
    assert _patched() == before and _flags() == flags
    ab_ladder.run_leg(["-e", "1"], dropout=True, train=lambda argv: seen.update(plain=_flags()))
    assert seen["plain"] == (False, False, True)


def test_leg_argv_is_the_ab_nuclei_linknet34_leg():
    argv = ab_ladder.leg_argv("d", "i.pth", 7, "x", epochs=20, device="cpu", steps=3)
    want = ab_nuclei.leg_argv("linknet34", "bce_jaccard", "adam", "1e-4", "d", "i.pth", 7, "x")
    want[want.index("-e") + 1] = "20"
    assert argv == want + ["--device", "cpu", "-s", "3"]


@pytest.fixture(scope="module")
def legs(module_tmp):  # noqa: F811
    """Two L0 legs, then two dropout-on legs, at a tiny size."""
    work, out = module_tmp("work"), module_tmp("out")
    ladder = ab_ladder.Ladder(work, out, epochs=1, **TINY)
    l0 = ladder.l0()
    on = [ladder.leg(f"on{i}", ab_ladder.L0_SEED, dropout=True).read_text() for i in range(2)]
    return dict(l0=l0, out=out, work=work, on=on)


def test_two_l0_legs_give_the_same_bits(legs):
    assert legs["l0"]["same_bits"]
    assert "bit for bit: yes" in (legs["out"] / "port_L0_repeat.txt").read_text()
    history = ab_ladder.read_csv(legs["out"] / "port_L0.csv")
    assert len(history["val_iou"]) == 1 and np.isfinite(history["loss"]).all()
    assert not list(Path(legs["work"]).rglob("*.pth"))[1:]  # only the init is kept


def test_dropout_on_draws_the_step_keyed_masks(legs):
    """Dropout on: the two legs draw the same masks (keyed by seed and
    step), and they differ from the dropout-off leg's."""
    off = (legs["out"] / "port_L0.csv").read_text()
    assert legs["on"][0] == legs["on"][1] != off


def _stand_in(out: Path):
    """segtpu's committed CSVs written as the port's."""
    ref = ab_ladder.REFERENCE_DIR
    shutil.copy(ref / "seg_L0.csv", out / "port_L0.csv")
    for s in ab_ladder.L1_SEEDS:
        shutil.copy(ref / f"segtpu_L1_s{s}.csv", out / f"port_L1_s{s}.csv")
        shutil.copy(ref / f"segtpu_L1_s{s}_20ep.csv", out / f"port_L1_s{s}_20ep.csv")


def test_report_renders_the_committed_csvs(tmp_path):  # noqa: F811
    _stand_in(tmp_path)
    text = ab_ladder.report(tmp_path, card="a card, 700.00 W")
    assert (tmp_path / "ladder.md").read_text() == text
    for head in ("## L0: dropout off too", "## L1: dropout on", "## L1 at 20 epochs",
                 "## The rule"):
        assert head in text
    # segtpu's own ladder: its 20-epoch mean lies +0.0059 from torch's
    assert "| 20260819 | 0.9158 | 0.9468 | 0.9468 | 0.9503 | 0.9597 | 0.9597 |" in text
    assert "Δ(segtpu−torch) +0.0059" in text and "not a port fault" in text
    assert "| 9 | 0.066080 | 0.065657 | 0.065657 |" in text


def test_verdict_rule():
    torch_l1 = [[0.5] * 10, [0.6] * 10, [0.7] * 10]
    ok = ab_ladder.verdict([[0.55] * 10] * 3, torch_l1, [0.95] * 3, [0.9531] * 3)
    assert not ok["port_fault"] and ok["bands_ok"] and ok["final_ok"]
    low = [r[:] for r in [[0.55] * 10] * 3]
    for r in low:
        r[8] = 0.45
    below = ab_ladder.verdict(low, torch_l1, [0.95] * 3, [0.9531] * 3)
    assert below["port_fault"] and below["relations"][8] == "BELOW" and below["final_ok"]
    far = ab_ladder.verdict([[0.55] * 10] * 3, torch_l1, [0.94] * 3, [0.9531] * 3)
    assert far["port_fault"] and far["bands_ok"] and not far["final_ok"]


def test_dropout2d_masks_have_segtpus_statistics():
    """p = 0.5 over 64 x 256 (sample, channel) draws, 8 times: each kept
    channel is x / (1 - p) at every pixel, each dropped one 0; the keep
    share lies within 4 sigma of 0.5 on both sides, and per channel the port
    and segtpu agree within the sampling noise of the two."""
    n, c, h, w, reps = 64, 256, 3, 3, 8
    x = np.random.default_rng(0).uniform(0.5, 1.5, (n, c, h, w)).astype(np.float32)
    mod = Dropout2d(0.5).train()
    jmod = JaxDropout2d(0.5)
    ours, theirs = [], []
    g = torch.Generator().manual_seed(0)
    for r in range(reps):
        state = torch.random.get_rng_state()
        torch.manual_seed(int(torch.randint(0, 2 ** 31, (1,), generator=g)))
        y = mod(torch.from_numpy(x)).numpy()
        torch.random.set_rng_state(state)
        jy = np.asarray(jmod.apply({}, jnp.asarray(x.transpose(0, 2, 3, 1)), False,
                                   rngs={"dropout": jax.random.PRNGKey(r)})).transpose(0, 3, 1, 2)
        for out, keep in ((y, ours), (jy, theirs)):
            kept = np.all(out == x * 2, axis=(2, 3))
            dropped = np.all(out == 0, axis=(2, 3))
            assert np.all(kept ^ dropped)
            keep.append(kept)
    sigma = np.sqrt(0.25 / (n * c * reps))
    ours, theirs = np.stack(ours), np.stack(theirs)
    assert abs(ours.mean() - 0.5) < 4 * sigma and abs(theirs.mean() - 0.5) < 4 * sigma
    # independent across samples and channels: neighbours agree half the time
    for keep in (ours, theirs):
        assert abs((keep[:, 1:] == keep[:, :-1]).mean() - 0.5) < 4 * np.sqrt(0.25 / keep[:, 1:].size)
        assert abs((keep[:, :, 1:] == keep[:, :, :-1]).mean() - 0.5) < \
            4 * np.sqrt(0.25 / keep[:, :, 1:].size)
    per_channel = ours.mean(axis=(0, 1)) - theirs.mean(axis=(0, 1))
    assert abs(per_channel.mean()) < 4 * np.sqrt(2 * 0.25 / (n * reps) / c)
