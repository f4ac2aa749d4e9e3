"""The LinkNet34 ladder of the port (counterpart of segtpu's tools/ab_ladder.py).

    python -m segtpu_torch.ab_ladder --phase l0 --work <dir> --out results/ab_ladder_port
    python -m segtpu_torch.ab_ladder --phase l1 --epochs 20 --work <dir> --out results/ab_ladder_port
    python -m segtpu_torch.ab_ladder --phase report --out results/ab_ladder_port
    python -m segtpu_torch.ab_ladder --phase l0 --bisect tf32 --bisect plain-norm ...

On the nuclei A/B the port's ``linknet34`` leg ends below segtpu's while it
passes the band rule against the torch reference. segtpu's own ladder
(``results/ab_ladder/ladder.md``) found the same shape between torch and
segtpu and named it: ``Dropout2d(p=0.5)`` before the head makes the 48-image
fixture's early training metastable, and the epoch at which a run escapes
the plateau decides its 10-epoch value. This module runs the port through
the same legs and compares them with the committed torch and segtpu CSVs.

Every leg is the port's train CLI in process, with the nuclei A/B's fixture
(48 images, seed 20260819), config (``linknet34`` + ``bce_jaccard`` + Adam
lr 1e-4, patch 128, batch 8), per-seed initial weights
(:func:`segtpu_torch.ab_nuclei.write_init`) and precision
(:func:`segtpu_torch.ab_nuclei.reference_precision`: fp32, TF32 off,
cuDNN's deterministic algorithms). The ladder's switches act outside the
training math, as segtpu's do, and each is undone when its leg ends:

  no augmentation  ``data.dsb2018._heavy_geometric`` returns ``[]``
  no shuffle       the train CLI's loaders get ``shuffle=False``
  no dropout       every dropout module of the CLI's model gets ``p = 0``
                   after ``get_model`` (a keyword of :func:`run_leg`; never
                   on by default, never an environment variable)

Phases:

  l0      dropout off too: one deterministic leg at seed 20260819, run twice;
          its gate is that both runs write the same CSV bit for bit. Its
          distance to ``torch_L0.csv`` / ``seg_L0.csv`` is reported, not
          gated: segtpu's ladder started both sides from a torch-built init
          that was never committed, so the port starts from its own draws.
  l1      dropout on: three seeds (20260819-21); ``--epochs 20`` writes the
          10-epoch CSV (the first 10 epochs of the same run) beside the
          20-epoch one.
  report  ``ladder.md`` in the form of segtpu's, the port's columns beside
          the committed torch and segtpu ones.

Bisect legs (``--bisect``, L0 only; diagnostics, never a fallback):
``tf32`` runs with TF32 on in cuDNN and matmuls (segtpu's "matmul precision
highest" leg, turned around: the port's legs already run at full fp32);
``plain-norm`` runs the plain PyTorch versions of B1/B2/B3 and the dx pass
instead of the kernels for that leg (segtpu's "BN impl=autodiff"). segtpu's
deconv-backward leg has no counterpart: the port's transposed convolutions
take torch's own backward.

The rule (:func:`verdict`). The port's offset against segtpu is segtpu's own
plateau-escape timing, and not a fault of the port, if both hold:

  * at every epoch 5-9 the port's L1 band (3 seeds) is not disjoint below
    torch's (``torch_L1_s*.csv``);
  * the mean of the port's three 20-epoch finals lies within 0.006 of
    torch's (0.9503, 0.9530, 0.9560: mean 0.9531). 0.006 is the scale of
    chaos plus 3-seed sampling that segtpu's ladder accepted for its own
    +0.0059 at 20 epochs.

Otherwise it is a port fault, to bisect with the legs above.
"""

from __future__ import annotations

import argparse
import csv
import shutil
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from segtpu_torch import ab_nuclei, train_cli
from segtpu_torch.data import dsb2018
from segtpu_torch.data.nuclei_fixture import write_fixture
from segtpu_torch.device import card_line, resolve_device
from segtpu_torch.ops import abn as abn_ops

MODEL, LOSS, OPT, LR = "linknet34", "bce_jaccard", "adam", "1e-4"
L0_SEED = 20260819
L1_SEEDS = ab_nuclei.RUN_SEEDS
EPOCHS = ab_nuclei.EPOCHS
BAND_EPOCHS = range(5, 10)
FINAL_TOL = 0.006
BISECT = ("tf32", "plain-norm")
# the card the legs ran on (nvidia-smi's name and power limit), beside the CSVs
CARD_FILE = "card.txt"
# the committed torch and segtpu CSVs in a checkout of the repository
REFERENCE_DIR = Path(__file__).resolve().parent.parent / "results" / "ab_ladder"


def _drop_p0(build: Callable) -> Callable:
    def get_model(*args, **kwargs):
        model = build(*args, **kwargs)
        for m in model.modules():
            if isinstance(m, torch.nn.modules.dropout._DropoutNd):
                m.p = 0.0
        return model
    return get_model


def _no_shuffle(loader_cls: Callable) -> Callable:
    def loader(*args, **kwargs):
        kwargs["shuffle"] = False
        return loader_cls(*args, **kwargs)
    return loader


def _plain(name, x, cuda_fn, plain_fn, *args):
    return plain_fn(x, *args)


@contextmanager
def ladder_switches(augment: bool = False, shuffle: bool = False, dropout: bool = True,
                    plain_norm: bool = False):
    """The ladder's switches on the train CLI (module docstring), undone on
    exit. ``plain_norm``: B1/B2/B3 and the dx pass run their plain PyTorch
    versions on any device."""
    saved = (dsb2018._heavy_geometric, train_cli.DataLoader, train_cli.get_model,
             abn_ops._on_device)
    try:
        if not augment:
            dsb2018._heavy_geometric = lambda: []
        if not shuffle:
            train_cli.DataLoader = _no_shuffle(saved[1])
        if not dropout:
            train_cli.get_model = _drop_p0(saved[2])
        if plain_norm:
            abn_ops._on_device = _plain
        yield
    finally:
        (dsb2018._heavy_geometric, train_cli.DataLoader, train_cli.get_model,
         abn_ops._on_device) = saved


def leg_argv(data_dir, init, seed: int, experiments_dir, epochs: int = EPOCHS,
             patch: int = ab_nuclei.PATCH, batch: int = ab_nuclei.BATCH,
             device: Optional[str] = None, steps: Optional[int] = None) -> List[str]:
    """The train CLI's flags of one leg: the nuclei A/B's ``linknet34`` leg
    at ``epochs``, ``patch`` and ``batch``; ``steps`` caps an epoch's train
    steps (``-s``, for a short run)."""
    argv = ab_nuclei.leg_argv(MODEL, LOSS, OPT, LR, data_dir, init, seed, experiments_dir)
    for flag, value in (("-e", epochs), ("-p", patch), ("-b", batch)):
        argv[argv.index(flag) + 1] = str(value)
    return (argv + (["--device", device] if device else [])
            + (["-s", str(steps)] if steps else []))


def run_leg(argv: Sequence[str], *, dropout: bool, augment: bool = False,
            shuffle: bool = False, tf32: bool = False, plain_norm: bool = False,
            train: Callable = train_cli.main):
    """One leg: ``train(argv)`` (default the train CLI) under the A/B's
    precision and the ladder's switches; ``tf32``: TF32 on in cuDNN and
    matmuls for this leg. Returns what ``train`` returns."""
    with ab_nuclei.reference_precision(), ladder_switches(augment, shuffle, dropout,
                                                          plain_norm):
        if tf32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        return train(list(argv))


def read_csv(path) -> Dict[str, List[float]]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


def _cut(src: Path, dst: Path, epochs: int) -> None:
    """The header and the first ``epochs`` rows of ``src``."""
    lines = src.read_text().splitlines(keepends=True)
    dst.write_text("".join(lines[:epochs + 1]))


class Ladder:
    """The fixture, the per-seed inits and the legs under ``work``; the
    port's CSVs in ``out``."""

    def __init__(self, work, out, epochs: int = EPOCHS, patch: int = ab_nuclei.PATCH,
                 batch: int = ab_nuclei.BATCH, images: int = ab_nuclei.FIXTURE_IMAGES,
                 device: Optional[str] = None, steps: Optional[int] = None):
        self.work, self.out = Path(work), Path(out)
        self.epochs, self.patch, self.batch, self.device = epochs, patch, batch, device
        self.steps = steps
        self.data_dir = self.work / "data" / "dsb2018"
        write_fixture(str(self.data_dir), images, ab_nuclei.FIXTURE_SEED)
        self.out.mkdir(parents=True, exist_ok=True)

    def leg(self, name: str, seed: int, **switches) -> Path:
        """Run one leg (:func:`run_leg`) in its own directory, delete its
        checkpoints, and return its CSV."""
        init = self.work / f"init_{MODEL}_s{seed}.pth"
        if not init.exists():
            ab_nuclei.write_init(MODEL, seed, init)
        exp_dir = self.work / name / "experiments"
        if exp_dir.exists():
            shutil.rmtree(exp_dir)
        argv = leg_argv(self.data_dir, init, seed, exp_dir, self.epochs, self.patch, self.batch,
                        self.device, self.steps)
        t0 = time.perf_counter()
        run_leg(argv, **switches)
        print(f"[ab_ladder] leg {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        for f in exp_dir.rglob("*.pth"):
            f.unlink()
        return ab_nuclei.csv_path(exp_dir, MODEL, LOSS, self.patch)

    def l0(self, bisect: Iterable[str] = ()) -> dict:
        """L0 twice, then each bisect leg; ``port_L0.csv`` (and
        ``port_L0_<leg>.csv``) in ``out``. Returns whether the two L0 runs
        wrote the same bytes."""
        first = self.leg("port_L0", L0_SEED, dropout=False)
        again = self.leg("port_L0_repeat", L0_SEED, dropout=False)
        same = first.read_bytes() == again.read_bytes()
        shutil.copy(first, self.out / "port_L0.csv")
        (self.out / "port_L0_repeat.txt").write_text(
            f"a second L0 run at seed {L0_SEED} wrote the same CSV bit for bit: "
            f"{'yes' if same else 'NO'}\n")
        for name in bisect:
            if name not in BISECT:
                raise ValueError(f"unknown bisect leg {name!r}; the legs: {BISECT}")
            path = self.leg(f"port_L0_{name}", L0_SEED, dropout=False,
                            **{name.replace("-", "_"): True})
            shutil.copy(path, self.out / f"port_L0_{name.replace('-', '_')}.csv")
        return dict(same_bits=same, csv=str(self.out / "port_L0.csv"))

    def l1(self) -> dict:
        """The three dropout-on legs; ``port_L1_s<S>.csv`` holds the first
        EPOCHS epochs and, when the legs run longer, ``port_L1_s<S>_<E>ep.csv``
        all of them."""
        written = []
        for seed in L1_SEEDS:
            path = self.leg(f"port_L1_s{seed}", seed, dropout=True)
            _cut(path, self.out / f"port_L1_s{seed}.csv", min(self.epochs, EPOCHS))
            written.append(f"port_L1_s{seed}.csv")
            if self.epochs > EPOCHS:
                shutil.copy(path, self.out / f"port_L1_s{seed}_{self.epochs}ep.csv")
                written.append(f"port_L1_s{seed}_{self.epochs}ep.csv")
        return dict(written=written)


def band(runs: Sequence[Sequence[float]], epoch: int):
    return min(r[epoch] for r in runs), max(r[epoch] for r in runs)


def verdict(port_l1: Sequence[Sequence[float]], torch_l1: Sequence[Sequence[float]],
            port_finals: Sequence[float], torch_finals: Sequence[float]) -> dict:
    """The rule of the module docstring: ``port_l1``/``torch_l1`` are the
    3-seed val-IoU histories (10 epochs), ``*_finals`` the 20-epoch finals."""
    relations = {e: ab_nuclei.band_relation([r[e] for r in port_l1], [r[e] for r in torch_l1])
                 for e in BAND_EPOCHS}
    port_mean = sum(port_finals) / len(port_finals)
    torch_mean = sum(torch_finals) / len(torch_finals)
    bands_ok = all(rel != "BELOW" for rel in relations.values())
    final_ok = abs(port_mean - torch_mean) <= FINAL_TOL
    return dict(relations=relations, bands_ok=bands_ok, port_final_mean=port_mean,
                torch_final_mean=torch_mean, final_delta=port_mean - torch_mean,
                final_ok=final_ok, port_fault=not (bands_ok and final_ok))


def _fmt(v: float, digits: int = 4) -> str:
    return f"{v:.{digits}f}"


def report(out, reference=REFERENCE_DIR, card: str = "", long_epochs: int = 20) -> str:
    """``ladder.md`` from the port's CSVs in ``out`` and the committed torch
    and segtpu CSVs in ``reference``; the sections whose CSVs are missing
    are left out. Returns the text and writes it to ``out/ladder.md``."""
    out, reference = Path(out), Path(reference)
    lines = [
        "# LinkNet34 ladder: the port (segtpu_torch) beside torch and segtpu",
        "",
        f"Fixture: {ab_nuclei.FIXTURE_IMAGES} images (seed {ab_nuclei.FIXTURE_SEED}), patch "
        f"{ab_nuclei.PATCH}, batch {ab_nuclei.BATCH}, `linknet34` + `bce_jaccard` + Adam lr {LR}; "
        "augmentations and shuffle off in every leg. "
        + (f"The port ran on {card} (nvidia-smi name, power limit) in fp32 (TF32 off, cuDNN's "
           "deterministic algorithms). " if card else "")
        + "The torch and segtpu columns are the committed CSVs of results/ab_ladder/; each port "
        "leg starts from the port's own init for its seed (segtpu_torch/ab_nuclei.py "
        "`write_init`), since segtpu's ladder started from a torch-built init that was never "
        "committed. Regenerate: `python -m segtpu_torch.ab_ladder --phase l0 --work <dir> --out "
        "results/ab_ladder_port`, `--phase l1 --epochs 20`, `--phase report`.",
        "",
    ]
    have = lambda p: p.exists()  # noqa: E731
    spreads = {}  # bisect leg -> largest |Δval_iou| over its epochs
    if have(out / "port_L0.csv") and have(reference / "torch_L0.csv"):
        t, s, p = (read_csv(reference / "torch_L0.csv"), read_csv(reference / "seg_L0.csv"),
                   read_csv(out / "port_L0.csv"))
        n = min(len(t["loss"]), len(s["loss"]), len(p["loss"]))
        lines += ["## L0: dropout off too (deterministic)", "",
                  "| epoch | torch loss | segtpu loss | port loss | torch val_iou | segtpu val_iou "
                  "| port val_iou | Δ(port−torch) | Δ(port−segtpu) |", "|" + "---|" * 9]
        for i in range(n):
            lines.append(
                f"| {i} | {t['loss'][i]:.6f} | {s['loss'][i]:.6f} | {p['loss'][i]:.6f} | "
                f"{_fmt(t['val_iou'][i])} | {_fmt(s['val_iou'][i])} | {_fmt(p['val_iou'][i])} | "
                f"{p['val_iou'][i] - t['val_iou'][i]:+.4f} | "
                f"{p['val_iou'][i] - s['val_iou'][i]:+.4f} |")
        lines.append("")
        repeat = out / "port_L0_repeat.txt"
        if have(repeat):
            lines += ["Determinism (L0's gate): " + repeat.read_text().strip() + ".", ""]
        lines += ["L0 is not gated against torch or segtpu: the three start from different "
                  "initial weights, so the distance is reported only.", ""]
        for name, label in (("tf32", "TF32 on (cuDNN and matmuls)"),
                            ("plain_norm", "B1/B2/B3 as their plain PyTorch versions")):
            path = out / f"port_L0_{name}.csv"
            if have(path):
                e = read_csv(path)
                lines += [f"### bisect leg: {label}", "",
                          "| epoch | Δloss vs port L0 | Δval_iou vs port L0 | Δval_iou vs torch |",
                          "|---|---|---|---|"]
                for i in range(min(n, len(e["loss"]))):
                    lines.append(f"| {i} | {e['loss'][i] - p['loss'][i]:+.6f} | "
                                 f"{e['val_iou'][i] - p['val_iou'][i]:+.4f} | "
                                 f"{e['val_iou'][i] - t['val_iou'][i]:+.4f} |")
                lines.append("")
                spreads[label + " against the port's L0"] = max(
                    abs(a - b) for a, b in zip(e["val_iou"][:n], p["val_iou"]))
        cpu = {k: out / f"cpu_{k}_L0.csv" for k in ("port", "segtpu")}
        if all(have(f) for f in cpu.values()):
            c = {k: read_csv(f) for k, f in cpu.items()}
            m = min(n, *(len(v["loss"]) for v in c.values()))
            lines += ["### bisect leg: segtpu from the port's init, on the CPU", "",
                      "The port's L0 init (`write_init`, seed "
                      f"{L0_SEED}) trained by segtpu's train CLI and by the port's, both on the "
                      "CPU in fp32 with the ladder's switches (segtpu: `LADDER_NO_AUG=1 "
                      "LADDER_NO_SHUFFLE=1 SEGTPU_DISABLE_DROPOUT=1 python tools/ab_ladder.py "
                      "--leg segtpu -- <the leg's flags> --init-torch <the port's init>`; the "
                      "port: `python -m segtpu_torch.ab_ladder --phase l0 --device cpu`), beside "
                      "the port's L0 on the card.", "",
                      "| epoch | port (card) val_iou | port (CPU) val_iou | segtpu (CPU) val_iou | "
                      "Δloss (port−segtpu, CPU) | Δval_iou (port−segtpu, CPU) |",
                      "|---|---|---|---|---|---|"]
            for i in range(m):
                lines.append(f"| {i} | {_fmt(p['val_iou'][i])} | "
                             f"{_fmt(c['port']['val_iou'][i])} | "
                             f"{_fmt(c['segtpu']['val_iou'][i])} | "
                             f"{c['port']['loss'][i] - c['segtpu']['loss'][i]:+.6f} | "
                             f"{c['port']['val_iou'][i] - c['segtpu']['val_iou'][i]:+.4f} |")
            lines.append("")
            spreads["the port against segtpu from one init on the CPU"] = max(
                abs(a - b) for a, b in zip(c["port"]["val_iou"][:m], c["segtpu"]["val_iou"]))

    seeds = list(L1_SEEDS)
    names = {k: [reference / f"{k}_L1_s{s}.csv" for s in seeds] for k in ("torch", "segtpu")}
    names["port"] = [out / f"port_L1_s{s}.csv" for s in seeds]
    if all(have(f) for fs in names.values() for f in fs):
        runs = {k: [read_csv(f)["val_iou"] for f in fs] for k, fs in names.items()}
        n = min(len(r) for rs in runs.values() for r in rs)
        lines += ["## L1: dropout on (3 seeds per side)", "",
                  "| epoch | torch val_iou band | segtpu val_iou band | port val_iou band | "
                  "port vs torch | port vs segtpu |", "|---|---|---|---|---|---|"]
        for i in range(n):
            b = {k: band(rs, i) for k, rs in runs.items()}
            rel_t = ab_nuclei.band_relation([r[i] for r in runs["port"]],
                                            [r[i] for r in runs["torch"]])
            rel_s = ab_nuclei.band_relation([r[i] for r in runs["port"]],
                                            [r[i] for r in runs["segtpu"]])
            lines.append(f"| {i} | {_fmt(b['torch'][0])} .. {_fmt(b['torch'][1])} | "
                         f"{_fmt(b['segtpu'][0])} .. {_fmt(b['segtpu'][1])} | "
                         f"{_fmt(b['port'][0])} .. {_fmt(b['port'][1])} | {rel_t} | {rel_s} |")
        fin = {k: [r[n - 1] for r in rs] for k, rs in runs.items()}
        mean = {k: sum(v) / len(v) for k, v in fin.items()}
        lines += ["", f"Final at epoch {n - 1}: mean Δ(port−torch) = "
                      f"{mean['port'] - mean['torch']:+.4f}, mean Δ(port−segtpu) = "
                      f"{mean['port'] - mean['segtpu']:+.4f}.", ""]

        long = {k: [reference / f"{k}_L1_s{s}_{long_epochs}ep.csv" for s in seeds]
                for k in ("torch", "segtpu")}
        long["port"] = [out / f"port_L1_s{s}_{long_epochs}ep.csv" for s in seeds]
        if all(have(f) for fs in long.values() for f in fs):
            lruns = {k: [read_csv(f)["val_iou"] for f in fs] for k, fs in long.items()}
            m = min(len(r) for rs in lruns.values() for r in rs)
            lines += [f"## L1 at {long_epochs} epochs", "",
                      f"| seed | torch @{n}ep | segtpu @{n}ep | port @{n}ep | torch @{m}ep | "
                      f"segtpu @{m}ep | port @{m}ep |", "|---|---|---|---|---|---|---|"]
            for j, s in enumerate(seeds):
                lines.append(f"| {s} | " + " | ".join(
                    _fmt(lruns[k][j][i]) for i in (n - 1, m - 1)
                    for k in ("torch", "segtpu", "port")) + " |")
            lfin = {k: [r[m - 1] for r in rs] for k, rs in lruns.items()}
            lmean = {k: sum(v) / len(v) for k, v in lfin.items()}
            lines += ["", f"Mean at {m} epochs: torch {lmean['torch']:.4f}, segtpu "
                          f"{lmean['segtpu']:.4f}, port {lmean['port']:.4f}; Δ(port−torch) "
                          f"{lmean['port'] - lmean['torch']:+.4f}, Δ(port−segtpu) "
                          f"{lmean['port'] - lmean['segtpu']:+.4f}, Δ(segtpu−torch) "
                          f"{lmean['segtpu'] - lmean['torch']:+.4f}.", ""]
            v = verdict(runs["port"], runs["torch"], lfin["port"], lfin["torch"])
            rels = ", ".join(f"{e}: {r}" for e, r in v["relations"].items())
            lines += [
                "## The rule", "",
                "Not a port fault if (a) at every epoch 5-9 the port's L1 band is not disjoint "
                "below torch's, and (b) the mean of the port's 20-epoch finals lies within "
                f"{FINAL_TOL} of torch's; otherwise a port fault, to bisect "
                "(segtpu_torch/ab_ladder.py).", "",
                f"- (a) port vs torch at epochs 5-9: {rels}: **{'holds' if v['bands_ok'] else 'FAILS'}**",
                f"- (b) port {v['port_final_mean']:.4f} against torch "
                f"{v['torch_final_mean']:.4f}: Δ {v['final_delta']:+.4f}, |Δ| "
                f"{'≤' if v['final_ok'] else '>'} {FINAL_TOL}: "
                f"**{'holds' if v['final_ok'] else 'FAILS'}**", "",
                "**Verdict: " + ("a port fault" if v["port_fault"] else
                                 "not a port fault; the port's offset against segtpu is "
                                 "segtpu's own plateau-escape timing") + ".**", ""]
            if v["port_fault"] and spreads:
                lines += ["Bisect legs run, each with its largest |Δval_iou| over the L0 "
                          "epochs: " + "; ".join(f"{k} {d:.4f}" for k, d in spreads.items())
                          + ". segtpu's own L0 variants (matmul precision, deconv backward, "
                          "BN autodiff) lay up to 0.0183 from torch (results/ab_ladder/"
                          "ladder.md).", ""]
    text = "\n".join(lines) + "\n"
    (out / "ladder.md").write_text(text)
    return text


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phase", default="all", choices=["l0", "l1", "report", "all"])
    p.add_argument("--work", default=None,
                   help="Directory for the fixture, inits and legs (needed by l0 and l1)")
    p.add_argument("--out", default=str(REFERENCE_DIR.parent / "ab_ladder_port"),
                   help="Where the port's CSVs and ladder.md go")
    p.add_argument("--reference", default=str(REFERENCE_DIR),
                   help="Directory of the committed torch_* and seg* CSVs")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--bisect", action="append", default=[], choices=BISECT,
                   help="L0: also run this bisect leg (repeatable)")
    p.add_argument("--device", default=None,
                   help="torch device of the legs (default cuda; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)
    if args.phase != "report":
        if args.work is None:
            p.error("--work is needed to run legs")
        on_card = resolve_device(args.device).type == "cuda"
        ladder = Ladder(args.work, args.out, epochs=args.epochs, device=args.device)
        if on_card:
            (Path(args.out) / CARD_FILE).write_text(card_line() + "\n")
        if args.phase in ("l0", "all"):
            result = ladder.l0(args.bisect)
            print(f"L0: the repeat wrote the same bits: {result['same_bits']}", flush=True)
            if not result["same_bits"]:
                return 1
        if args.phase in ("l1", "all"):
            ladder.l1()
    card = Path(args.out) / CARD_FILE
    print(report(args.out, args.reference, card.read_text().strip() if card.exists() else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
