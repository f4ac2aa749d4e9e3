"""Cross-experiment loss and metric plots from history CSVs (counterpart of
segtpu/reporting/plot.py; reference plot.py:10-89).

Reads the CSVs that ``segtpu_torch.train_cli`` writes,
``<experiments-dir>/<dataset>/<loss>/<experiment>/<experiment>.csv`` with
the columns epoch, loss, val_loss, iou, accuracy, val_iou, val_accuracy,
and saves per-experiment train/val curves and cross-experiment comparisons
as PNG files:

    python -m segtpu_torch.reporting.plot --experiments-dir experiments \\
        --dataset dsb2018 --loss bce --out report/
"""

from __future__ import annotations

import argparse
import glob
import os


def _pyplot():
    """matplotlib's pyplot on the Agg backend, in seaborn's style where
    seaborn is installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    try:
        import seaborn as sns
        sns.set()
    except ImportError:
        pass
    return plt


def _save(fig, out):
    if out:
        fig.savefig(out, dpi=120)
        _pyplot().close(fig)
    return fig


def plot_train_history(names, loss, val_loss, title=None, legend_loc="upper right", out=None):
    """Every experiment's train and test curves side by side (reference plot.py:10-35)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(15, 8))
    if title is not None:
        fig.suptitle(title)
    ax1, ax2 = fig.subplots(1, 2)
    for ax, curves, label in ((ax1, loss, "Train"), (ax2, val_loss, "Test")):
        for m in curves:
            ax.plot(m)
        ax.set_ylabel("Value")
        ax.set_xlabel("Epoch")
        ax.set_title(label)
        ax.legend(names, loc=legend_loc)
    return _save(fig, out)


def plot_experiment_train_history(name, loss, val_loss, metric, val_metric, out=None):
    """One experiment's loss and score, train against test (reference plot.py:38-61)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(15, 8))
    fig.suptitle(name)
    ax1, ax2 = fig.subplots(1, 2)
    for ax, pair, title, loc in ((ax1, (loss, val_loss), "Loss", "upper right"),
                                 (ax2, (metric, val_metric), "Score", "upper left")):
        for curve in pair:
            ax.plot(curve)
        ax.set_ylabel("Value")
        ax.set_xlabel("Epoch")
        ax.set_title(title)
        ax.legend(["Train", "Test"], loc=loc)
    return _save(fig, out)


def discover_experiments(experiments_dir: str, dataset: str, loss: str):
    """``{experiment: DataFrame}`` of every CSV under
    ``<experiments_dir>/<dataset>/<loss>/*/``, by name."""
    import pandas as pd

    pattern = os.path.join(experiments_dir, dataset, loss, "*", "*.csv")
    return {os.path.splitext(os.path.basename(path))[0]: pd.read_csv(path)
            for path in sorted(glob.glob(pattern))}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments-dir", default="experiments")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--loss", required=True)
    parser.add_argument("--metric", default="iou")
    parser.add_argument("--out", default="report")
    args = parser.parse_args(argv)

    experiments = discover_experiments(args.experiments_dir, args.dataset, args.loss)
    if not experiments:
        raise SystemExit(
            f"no experiment CSVs under {args.experiments_dir}/{args.dataset}/{args.loss}")
    os.makedirs(args.out, exist_ok=True)

    names, loss_l, val_loss_l, metric_l, val_metric_l = [], [], [], [], []
    for key, item in experiments.items():
        names.append(key)
        loss_l.append(item[["loss"]])
        val_loss_l.append(item[["val_loss"]])
        metric_l.append(item[[args.metric]])
        val_metric_l.append(item[["val_" + args.metric]])
        plot_experiment_train_history(key, item[["loss"]], item[["val_loss"]],
                                      item[[args.metric]], item[["val_" + args.metric]],
                                      out=os.path.join(args.out, f"{key}.png"))

    plot_train_history(names, loss_l, val_loss_l, f"{args.dataset}, {args.loss} loss",
                       out=os.path.join(args.out, "all_loss.png"))
    plot_train_history(names, metric_l, val_metric_l, f"{args.dataset}, {args.metric} score",
                       legend_loc="lower right", out=os.path.join(args.out, "all_metric.png"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
