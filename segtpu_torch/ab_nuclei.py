"""Accuracy A/B of the port against the committed nuclei bands (counterpart
of segtpu's tools/ab_nuclei.py).

    python -m segtpu_torch.ab_nuclei --work <dir> [--out results/ab_nuclei_port]
                                     [--reference results/ab_nuclei]

Writes the seeded nuclei fixture (48 images, seed 20260819) in the DSB2018
layout, trains the port's train CLI on it in process, one leg per run seed
(20260819-21) and config, with segtpu's A/B flags: ``zf_unet`` + ``bce`` +
SGD lr 1e-3 and ``linknet34`` + ``bce_jaccard`` + Adam lr 1e-4, patch 128,
batch 8, 10 epochs, on the card at the reference's precision: fp32 with
TF32 off in cuDNN and matmuls, and cuDNN's deterministic algorithms, as the
reference's CPU legs ran. Then it holds each config's 3-seed band of
validation IoU against the torch reference's committed band
(``<reference>/torch_<model>_s<S>.csv``; segtpu's beside it) with the
rule of ``results/ab_nuclei/comparison.md``: at every epoch of the second
half the port's band intersects the torch band or lies above it. A band
disjoint below is the failure, and the exit code is 1.

The reference's own initial weights were never committed, so each leg starts
from weights drawn in the reference's distribution, seeded by the run seed S
and passed with ``--init-torch``: ``zf_unet`` the port's own init (torch's
``nn.Conv2d`` default, U(+-1/sqrt(fan_in)), as the reference's); ``linknet34``
the same for the decoder, and in the encoder torchvision's ``resnet34`` init,
``kaiming_normal_(mode="fan_out", nonlinearity="relu")`` for every conv and
BatchNorm at weight 1, bias 0.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

from segtpu_torch import train_cli
from segtpu_torch.data.nuclei_fixture import write_fixture
from segtpu_torch.device import resolve_device
from segtpu_torch.models import ENCODER_PREFIXES, get_model
from segtpu_torch.models.layers import Conv

FIXTURE_IMAGES, FIXTURE_SEED = 48, 20260819
RUN_SEEDS = (20260819, 20260820, 20260821)
PATCH, BATCH, EPOCHS = 128, 8, 10
# (model, loss, optimizer, lr): segtpu's A/B configs (tools/ab_nuclei.py:41-45)
CONFIGS = (("zf_unet", "bce", "sgd", "1e-3"), ("linknet34", "bce_jaccard", "adam", "1e-4"))
# the committed bands in a checkout of the repository
REFERENCE_DIR = Path(__file__).resolve().parent.parent / "results" / "ab_nuclei"


def experiment_name(model: str, loss: str, patch: int = PATCH) -> str:
    return f"dsb2018_{model}_{patch}_rgb_{loss}"


def csv_path(experiments_dir, model: str, loss: str, patch: int = PATCH) -> Path:
    """Where the train CLI writes a leg's history (segtpu's
    ``experiments/dsb2018/<loss>/<experiment>/<experiment>.csv``)."""
    exp = experiment_name(model, loss, patch)
    return Path(experiments_dir) / "dsb2018" / loss / exp / f"{exp}.csv"


def write_init(model: str, seed: int, path) -> None:
    """A reference-format state_dict of ``model`` drawn in the reference's
    distribution from ``seed`` (see the module docstring)."""
    net = get_model(model, patch_size=PATCH, device="cpu", seed=seed)
    if model == "linknet34":
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, m in net.named_modules():
                if isinstance(m, Conv) and (name + ".").startswith(ENCODER_PREFIXES[model]):
                    torch.nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                                  generator=g)
    torch.save(net.state_dict(), path)


def leg_argv(model: str, loss: str, optimizer: str, lr: str, data_dir, init, seed: int,
             experiments_dir) -> List[str]:
    return ["-m", model, "-d", "dsb2018", "-dd", str(data_dir), "-p", str(PATCH),
            "-b", str(BATCH), "-l", loss, "-o", optimizer, "-lr", lr, "-e", str(EPOCHS),
            "--seed", str(seed), "--no-tensorboard", "--light-logging",
            "--init-torch", str(init), "--experiments-dir", str(experiments_dir)]


@contextmanager
def reference_precision():
    """The legs' numerics: fp32 convolutions and matmuls without TF32, and
    cuDNN's deterministic algorithms, so that a leg gives the same bits on
    every run. The flags are restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def read_val_iou(path) -> List[float]:
    with open(path, newline="") as f:
        return [float(row["val_iou"]) for row in csv.DictReader(f)]


def band_relation(port: Sequence[float], ref: Sequence[float]) -> str:
    """"above" when the port's worst seed beats the reference's best, "BELOW"
    when its best falls under the reference's worst, else "overlap"."""
    if min(port) > max(ref):
        return "above"
    if max(port) < min(ref):
        return "BELOW"
    return "overlap"


def compare(port: Dict[int, List[float]], torch_ref: Dict[int, List[float]],
            segtpu: Dict[int, List[float]]) -> dict:
    """One config's verdict: per epoch the three bands over the run seeds
    and the port's relation to the torch band; ``ok`` unless a leg is short
    or the port's band lies below the torch band at an epoch of the second
    half."""
    n = min(len(v) for runs in (port, torch_ref, segtpu) for v in runs.values())
    rows = []
    for i in range(n):
        bands = {name: [min(r[i] for r in runs.values()), max(r[i] for r in runs.values())]
                 for name, runs in (("torch", torch_ref), ("segtpu", segtpu), ("port", port))}
        rows.append(dict(epoch=i, **bands,
                         relation=band_relation([r[i] for r in port.values()],
                                                [r[i] for r in torch_ref.values()])))

    def final_mean(runs):
        return sum(r[n - 1] for r in runs.values()) / len(runs)

    return dict(rows=rows, epochs=n,
                ok=n >= EPOCHS and all(r["relation"] != "BELOW" for r in rows[n // 2:]),
                final={name: {s: r[n - 1] for s, r in runs.items()}
                       for name, runs in (("torch", torch_ref), ("segtpu", segtpu),
                                          ("port", port))},
                delta_vs_torch=final_mean(port) - final_mean(torch_ref),
                delta_vs_segtpu=final_mean(port) - final_mean(segtpu))


def report(verdicts: dict, card: str) -> str:
    lines = [
        "# Nuclei-fixture A/B: the port (segtpu_torch) against the torch reference and segtpu",
        "",
        f"Fixture: {FIXTURE_IMAGES} images (seed {FIXTURE_SEED}), patch {PATCH}, batch {BATCH}, "
        f"{EPOCHS} epochs, run seeds {list(RUN_SEEDS)}, the seed-1234 stratified patch split. "
        f"The port ran on {card} in fp32 (TF32 off in cuDNN and matmuls; cuDNN's deterministic "
        "algorithms). The torch and segtpu bands are the committed CSVs of "
        "results/ab_nuclei/. Each port leg starts from weights drawn in the reference's "
        "distribution from its run seed (segtpu_torch/ab_nuclei.py). Parity holds if, at every "
        "epoch of the second half, the port's 3-seed band intersects the torch band or lies "
        "above it; the failure is the port's band disjoint below. Regenerate: `python -m "
        "segtpu_torch.ab_nuclei --work <dir> --out results/ab_nuclei_port`, or `python3 "
        "chip_smoke.py --ab-out <dir>`.",
        "",
    ]
    for (model, loss, opt, lr), v in zip(CONFIGS, verdicts.values()):
        if v["epochs"] < EPOCHS:
            lines.append(f"**WARNING: {model} compared over {v['epochs']}/{EPOCHS} epochs: a leg "
                         "is short.**")
        lines += [f"## {model} ({loss} + {opt}, lr {lr})", "",
                  "| epoch | torch band (min..max) | segtpu band (min..max) | port band (min..max) "
                  "| port vs torch |", "|---|---|---|---|---|"]
        for r in v["rows"]:
            lines.append("| {} | {:.4f} .. {:.4f} | {:.4f} .. {:.4f} | {:.4f} .. {:.4f} | {} |"
                         .format(r["epoch"], *r["torch"], *r["segtpu"], *r["port"],
                                 r["relation"]))
        lines += ["", f"Final epoch: mean Δ(port−torch) = **{v['delta_vs_torch']:+.4f}**, mean "
                      f"Δ(port−segtpu) = **{v['delta_vs_segtpu']:+.4f}**; the port's band "
                      "intersects the torch band (or lies above) at every epoch of the second "
                      f"half: **{'yes' if v['ok'] else 'NO'}**", "",
                  "Per-seed final val_iou: " + "; ".join(
                      f"s{s}: torch {v['final']['torch'][s]:.4f} / segtpu "
                      f"{v['final']['segtpu'][s]:.4f} / port {v['final']['port'][s]:.4f}"
                      for s in RUN_SEEDS), ""]
    return "\n".join(lines) + "\n"


def train_leg(argv: List[str], model: str) -> dict:
    """One leg: the train CLI in process."""
    return train_cli.main(argv)


def run(work, out=None, run_leg: Callable = train_leg, card: str = "",
        reference=REFERENCE_DIR) -> dict:
    """The fixture, the legs (``run_leg(argv, model)`` trains one, under
    :func:`reference_precision`; default the train CLI), then the comparison
    with the committed CSVs in ``reference``: ``{model: verdict}``. With
    ``out``, writes ``comparison.md`` and the port's CSVs
    ``port_<model>_s<S>.csv`` there."""
    reference = Path(reference)
    work = Path(work)
    data_dir = work / "data" / "dsb2018"
    write_fixture(str(data_dir), FIXTURE_IMAGES, FIXTURE_SEED)
    verdicts = {}
    for model, loss, opt, lr in CONFIGS:
        port = {}
        for seed in RUN_SEEDS:
            init = work / f"init_{model}_s{seed}.pth"
            write_init(model, seed, init)
            exp_dir = work / f"port_s{seed}" / "experiments"
            with reference_precision():
                run_leg(leg_argv(model, loss, opt, lr, data_dir, init, seed, exp_dir), model)
            port[seed] = read_val_iou(csv_path(exp_dir, model, loss))
            if out is not None:
                os.makedirs(out, exist_ok=True)
                shutil.copy(csv_path(exp_dir, model, loss), Path(out) / f"port_{model}_s{seed}.csv")
        ref = {s: read_val_iou(reference / f"torch_{model}_s{s}.csv") for s in RUN_SEEDS}
        seg = {s: read_val_iou(reference / f"segtpu_{model}_s{s}.csv") for s in RUN_SEEDS}
        verdicts[model] = compare(port, ref, seg)
    if out is not None:
        (Path(out) / "comparison.md").write_text(report(verdicts, card))
    return verdicts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work", required=True, help="Directory for the fixture, inits and legs")
    p.add_argument("--out", default=None,
                   help="Where to write comparison.md and the port's CSVs")
    p.add_argument("--reference", default=str(REFERENCE_DIR),
                   help="Directory of the committed torch_* and segtpu_* CSVs (default: "
                        "results/ab_nuclei of this checkout)")
    args = p.parse_args(argv)
    card = torch.cuda.get_device_name(resolve_device(None))
    verdicts = run(args.work, args.out, card=card, reference=args.reference)
    print(report(verdicts, card))
    return 0 if all(v["ok"] for v in verdicts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
