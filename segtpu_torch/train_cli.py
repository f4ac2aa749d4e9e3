"""Training harness CLI of the port (counterpart of segtpu/train_cli.py;
reference torch_train.py:333-451).

One grid cell: argparse -> registries build model, loss, optimizer and
dataset -> the epoch loop, a train epoch then a validation epoch -> history
-> best and last checkpoints -> the CSV at the end. Flags and defaults are
segtpu's, plus ``--device``; runs on CUDA unless ``--device cpu``.

    python -m segtpu_torch.train_cli -m linknet34 -d shapes-device -l bce_jaccard \\
        -o adam -b 16 -p 512 -e 2 --bf16 --no-tensorboard

Several ranks (segtpu/train_cli.py:161,290-330,391-395): under ``torchrun``
(``torchrun --nproc_per_node N -m segtpu_torch.train_cli ...``) every rank
runs this CLI; ``-b`` is the global batch, split over ``N / model_parallel``
data ranks, each normalising with sync BatchNorm over the data group;
``--model-parallel M`` shards the conv channels over groups of M ranks
(:mod:`segtpu_torch.parallel.tensor`). Rank 0 alone writes the checkpoints,
the CSV and the event files; a checkpoint holds the full weights and loads
in a one-process run.

Needs neither pandas, tqdm nor scikit-learn; cv2 for the datasets on files
(``dsb2018``, ``inria*``); tensorboardX only when the writer is on (no
``--no-tensorboard``).
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import random
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

import torch.distributed as dist

from segtpu_torch.augment.device import get_device_pipelines
from segtpu_torch.compat.encoder_weights import install_encoder_weights
from segtpu_torch.data import get_dataset
from segtpu_torch.data.dsb2018 import DSB2018Sliced
from segtpu_torch.data.inria import INRIA
from segtpu_torch.data.pipeline import DataLoader, Subset
from segtpu_torch.data.shapes import DeviceShapesSet, ShapesDataset
from segtpu_torch.models import get_model, place_model, without_encoder
from segtpu_torch.models.layers import set_data_shard, set_process_group
from segtpu_torch.ops.losses import get_loss
from segtpu_torch.ops.metrics import default_metrics
from segtpu_torch.parallel import fit_data_parallel, make_grid, replicate
from segtpu_torch.parallel import tensor as tensor_parallel
from segtpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device
from segtpu_torch.train.checkpoint import read_snapshot, write_snapshot
from segtpu_torch.train.loop import run_train_epoch, run_validate_epoch
from segtpu_torch.train.optim import cosine_annealing_lr, get_optimizer
from segtpu_torch.train.state import make_eval_step, make_train_step
from segtpu_torch.utils import count_parameters

def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-g", "--grayscale", action="store_true",
                        help="Whether to use grayscale image instead of RGB")
    parser.add_argument("-m", "--model", required=True, type=str, help="Name of the model")
    parser.add_argument("-p", "--patch-size", type=int, default=224)
    parser.add_argument("-b", "--batch-size", type=int, default=1,
                        help="Batch Size during training, e.g. -b 64")
    parser.add_argument("-lr", "--learning-rate", type=float, default=1e-3,
                        help="Initial learning rate")
    parser.add_argument("-l", "--loss", type=str, default="bce", help="Target loss")
    parser.add_argument("-o", "--optimizer", default="SGD", help="Name of the optimizer")
    parser.add_argument("-e", "--epochs", type=int, default=100, help="Epoch to run")
    parser.add_argument("-d", "--dataset", type=str,
                        help="Name of the dataset to use for training.")
    parser.add_argument("-dd", "--data-dir", type=str, default="data",
                        help="Root directory where datasets are located.")
    parser.add_argument("-s", "--steps", type=int, default=None,
                        help="Steps per epoch (caps the train set to steps * batch and "
                             "the validation set to max(steps // 4, 1) batches)")
    parser.add_argument("-x", "--experiment", type=str, help="Name of the experiment")
    parser.add_argument("-w", "--workers", default=0, type=int,
                        help="Loader threads (0: 4)")
    parser.add_argument("-r", "--resume", action="store_true",
                        help="Resume from the best checkpoint of the experiment")
    parser.add_argument("-mem", "--memory", action="store_true")
    parser.add_argument("-sgdr", action="store_true",
                        help="Cosine-annealed learning rate (T_max 10, eta_min 1e-8)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 autocast (parameters stay fp32)")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="Ranks per model group: conv channels are sharded over them "
                             "(run under torchrun with a multiple of it)")
    parser.add_argument("--s2d", action="store_true",
                        help="Space-to-depth execution of the full-resolution level for models "
                             "that have it (the same math; segtpu_torch.ops.s2d)")
    parser.add_argument("--remat", action="store_true",
                        help="Per-block rematerialization for models that have it (zf_unet, "
                             "tiramisu*)")
    parser.add_argument("--packed", action="store_true",
                        help="Packed dense-block growth for models that have it (tiramisu*): "
                             "layers append to one buffer per block (the same math). With "
                             "--s2d, the full-resolution s2d block keeps the concat")
    parser.add_argument("--light-logging", action="store_true",
                        help="Skip per-epoch image grids and weight histograms")
    parser.add_argument("--no-tensorboard", action="store_true")
    parser.add_argument("--experiments-dir", type=str, default="experiments")
    parser.add_argument("--snapshot-every", type=int, default=1,
                        help="Save the last-epoch snapshot every N epochs (0 disables "
                             "both checkpoints)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the first training "
                             "epoch into this directory")
    parser.add_argument("--device-augs", action="store_true",
                        help="Augment on the device inside the train step (raw loaders; "
                             "shapes, dsb2018 and inria*)")
    parser.add_argument("--freeze-encoder", action="store_true",
                        help="Freeze the encoder's parameters (zero gradients)")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed random, np.random and torch, the loader's shuffle and "
                             "the per-sample host streams. Default: shuffle seed 0, "
                             "torch seed 42, host streams unseeded")
    parser.add_argument("--init-torch", type=str, default=None,
                        help="Reference-format .pth (a state_dict or a full snapshot) "
                             "loaded into the model before training")
    parser.add_argument("--encoder-weights", type=str, default=None,
                        help="Local torchvision-format .pth of the encoder's weights, "
                             "loaded before training (and before -r's checkpoint)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to train on (default cuda; a missing GPU is an error)")
    return parser


def _csv_cell(value) -> str:
    """A history value as pandas' ``to_csv`` writes it: NaN empty, a float
    by its shortest repr, anything else by ``str``."""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_history_csv(path: str, train_history: Dict[str, list], append: bool) -> None:
    """``pd.DataFrame(train_history).to_csv(path, index=False)``, with the
    ``csv`` module: the header unless ``append``, then one row per epoch."""
    keys = list(train_history)
    with open(path, "a" if append else "w", newline="") as f:
        out = csv.writer(f, lineterminator=os.linesep)
        if not append:
            out.writerow(keys)
        for row in zip(*(train_history[k] for k in keys)):
            out.writerow([_csv_cell(v) for v in row])


def _make_writer(experiment: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        raise SystemExit("tensorboardX is not installed: pass --no-tensorboard") from None
    return SummaryWriter(comment="_" + experiment)


def device_aug_sets(args):
    """``(augment_fn, eval_transform_fn, (trainset, validset))`` of
    ``--device-augs`` (segtpu/train_cli.py:194-229): the dataset's device
    pipelines and its raw loaders. Exits for ``-g`` and for a dataset
    without a device pipeline."""
    if args.grayscale:
        raise SystemExit("--device-augs pipelines are RGB (3-channel normalization); "
                         "drop -g or use the host augmentation path")
    pipelines = get_device_pipelines(args.dataset)
    if pipelines is None:
        raise SystemExit(f"--device-augs not supported for {args.dataset}")
    name = args.dataset.lower()
    if name == "shapes":
        sets = (ShapesDataset(1024, args.patch_size, normalize=False),
                ShapesDataset(128, args.patch_size, seed=1_000_000, normalize=False))
    elif name == "dsb2018":
        sets = DSB2018Sliced(args.data_dir, args.grayscale, args.patch_size, raw=True)[:2]
    elif name in ("inria", "inria-small"):
        sets = INRIA(args.data_dir, args.grayscale, args.patch_size, args.memory,
                     small=name == "inria-small", raw=True)[:2]
    else:
        raise SystemExit("--device-augs raw loaders wired for shapes/dsb2018/inria")
    return pipelines[0], pipelines[1], sets


def main(argv=None, *, param_penalty: Optional[Callable] = None,
         model_builder: Optional[Callable] = None, trainable_mask_fn: Optional[Callable] = None,
         model_initializer: Optional[Callable] = None, experiment_prefix: str = ""):
    """Run one training grid cell; returns ``train_history``.

    Hooks for the other trainers:
      * ``param_penalty(model) -> 0-d tensor``, added to the scaled loss
        (the regularised trainer, torch_train_reg.py:92-97);
      * ``model_builder(args, num_channels) -> nn.Module``, in place of the
        registry's model;
      * ``trainable_mask_fn(model) -> set of parameter names that train``;
      * ``model_initializer(model, args)``, e.g. to load frozen weights.
    """
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.dataset is None:
        parser.error("the following arguments are required: -d/--dataset")
    owns_group = not dist.is_initialized()
    distributed = maybe_initialize_distributed(args.device)
    device = rank_device(args.device)
    try:
        grid = make_grid(args.model_parallel)
    except ValueError as e:
        raise SystemExit(f"--model-parallel {args.model_parallel}: {e}") from None
    n_data = fit_data_parallel(args.batch_size, grid.data_size)
    if n_data != grid.data_size:
        raise SystemExit(f"-b {args.batch_size} does not split over {grid.data_size} data ranks; "
                         f"launch {n_data * grid.model_size} ranks (data parallel {n_data} x "
                         f"model parallel {grid.model_size})")
    say = print if grid.is_main else (lambda *a, **k: None)

    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
    torch.manual_seed(42 if args.seed is None else args.seed)

    if args.experiment is None:
        args.experiment = "%s%s_%s_%d_%s_%s" % (
            experiment_prefix, args.dataset, args.model, args.patch_size,
            "gray" if args.grayscale else "rgb", args.loss)
    experiment_dir = os.path.join(args.experiments_dir, args.dataset, args.loss, args.experiment)
    os.makedirs(experiment_dir, exist_ok=True)

    writer = None
    if not args.no_tensorboard:
        # every rank logs alike (the logging forwards and the PR curve's counts
        # are collective); rank 0 alone writes
        writer = _make_writer(args.experiment) if grid.is_main else _NullWriter()
    arg_line = " ".join(sys.argv[1:] if argv is None else argv)
    if grid.is_main:
        with open(os.path.join(experiment_dir, "arguments.txt"), "w") as f:
            f.write(arg_line)

    augment_fn = eval_transform_fn = None
    if args.device_augs:
        augment_fn, eval_transform_fn, (trainset, validset) = device_aug_sets(args)
    else:
        trainset, validset, _ = get_dataset(args.dataset, args.data_dir,
                                            grayscale=args.grayscale,
                                            patch_size=args.patch_size, keep_in_mem=args.memory)
    if args.steps is not None and args.steps > 0:
        n_train, n_val = args.steps * args.batch_size, max(args.steps // 4, 1) * args.batch_size
        if isinstance(trainset, DeviceShapesSet):
            trainset, validset = trainset.take(n_train), validset.take(n_val)
        else:
            trainset, validset = Subset(trainset, n_train), Subset(validset, n_val)
    num_channels = getattr(trainset, "num_channels", None)
    if num_channels is None:
        num_channels = int(np.asarray(trainset[0][0]).shape[-1])

    if model_builder is not None:
        model = place_model(model_builder(args, num_channels), device)
    else:
        model = get_model(args.model, patch_size=args.patch_size, num_channels=num_channels,
                          device=device)
    if args.s2d:
        if not hasattr(model, "s2d"):
            raise SystemExit(f"--s2d: model '{args.model}' has no s2d mode")
        model.s2d = True
    if args.remat:
        if not hasattr(model, "remat"):
            raise SystemExit(f"--remat: model '{args.model}' has no remat mode")
        model.remat = True
    if args.packed:
        if not hasattr(model, "packed"):
            raise SystemExit(f"--packed: model '{args.model}' has no packed mode")
        model.packed = True
    if args.init_torch:
        sd = torch.load(args.init_torch, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "model" in sd:  # a full reference snapshot
            sd = sd["model"]
        model.load_state_dict(sd, strict=True)
        say("Torch weights loaded from", args.init_torch)
    if args.encoder_weights:
        install_encoder_weights(args.model, model, args.encoder_weights)
        say("Encoder weights loaded from", args.encoder_weights)
    if model_initializer is not None:
        model_initializer(model, args)

    start_epoch, best_loss, train_history = 0, np.inf, {}
    checkpoint_filename = os.path.join(experiment_dir, f"{args.model}_checkpoint.pth")
    snapshot_filename = os.path.join(experiment_dir, f"{args.model}_snapshot.pth")
    resumed = None
    if args.resume:
        # the full weights load before the model is sharded; the optimizer
        # state once the optimizer exists (segtpu_torch.parallel.tensor)
        resumed = read_snapshot(checkpoint_filename)
        model.load_state_dict(resumed["model"])
        if "optimizer" not in resumed:
            raise KeyError(f"{checkpoint_filename} holds no optimizer state")

    n_params = count_parameters(model)
    if grid.world > 1:
        replicate(model)
    set_process_group(model, grid.data_group)
    set_data_shard(model, grid.data_rank, grid.data_size)
    sharded = tensor_parallel.shard_model(model, grid)

    trainable = trainable_mask_fn(model) if trainable_mask_fn else None
    if args.freeze_encoder:
        names = trainable if trainable is not None else {n for n, _ in model.named_parameters()}
        try:
            trainable = without_encoder(args.model, names)
        except ValueError as e:
            raise SystemExit(f"--freeze-encoder: {e}") from None

    loss_fn = get_loss(args.loss)
    optimizer = get_optimizer(args.optimizer, model.parameters(), args.learning_rate)
    metrics = default_metrics()
    if resumed is not None:
        opt_state = resumed["optimizer"]
        if sharded:
            opt_state = tensor_parallel.shard_optimizer_state(opt_state, model, sharded, grid)
        optimizer.load_state_dict(opt_state)
        start_epoch, train_history, best_loss = (resumed["epoch"] + 1, resumed["train_history"],
                                                 resumed["loss"])
        say("Resuming training from epoch", start_epoch, " and loss", best_loss)

    say("Train set size", len(trainset))
    say("Valid set size", len(validset))
    say("Model         ", args.model)
    say("Parameters    ", n_params)
    say("Device        ", device, torch.cuda.get_device_name(device) if device.type == "cuda"
        else "")
    if grid.world > 1:
        say("Ranks         ", grid.world, f"(data {grid.data_size} x model {grid.model_size});",
            "parameters on rank 0:", count_parameters(model))

    if isinstance(trainset, DeviceShapesSet):
        trainloader = trainset.loader(args.batch_size, device, grid.data_rank, grid.data_size)
        validloader = validset.loader(args.batch_size, device, grid.data_rank, grid.data_size)
    else:
        # seeded runs bind a stateless per-sample stream around each sample
        # (augment.host.bind_sample_rng): bit-identical at any -w
        workers = args.workers if args.workers > 0 else 4
        trainloader = DataLoader(trainset, batch_size=args.batch_size, shuffle=True,
                                 workers=workers, drop_last=True,
                                 seed=args.seed if args.seed is not None else 0,
                                 sample_seed=args.seed, process_index=grid.data_rank,
                                 process_count=grid.data_size)
        validloader = DataLoader(validset, batch_size=args.batch_size, shuffle=False,
                                 workers=workers, drop_last=True, process_index=grid.data_rank,
                                 process_count=grid.data_size)

    train_step = make_train_step(model, optimizer, loss_fn, metrics, bf16=args.bf16,
                                 trainable_mask=trainable, param_penalty=param_penalty,
                                 augment_fn=augment_fn,
                                 seed=42 if args.seed is None else args.seed, grid=grid)
    # every epoch has len(trainloader) steps (drop_last), so a resumed run's
    # step count is segtpu's restored state.step
    train_step.step = start_epoch * len(trainloader)
    eval_step = make_eval_step(model, loss_fn, metrics, bf16=args.bf16,
                               with_pr_curve=writer is not None, grid=grid)
    metric_names = list(metrics)

    def snapshot(path, loss, epoch):
        # collective under model parallelism: every rank gathers, rank 0 writes
        if sharded:
            model_state = tensor_parallel.full_state_dict(model, sharded, grid)
            opt_state = tensor_parallel.full_optimizer_state(optimizer, model, sharded, grid)
        else:
            model_state, opt_state = model.state_dict(), optimizer.state_dict()
        if grid.is_main:
            write_snapshot(path, model_state, opt_state, epoch=epoch, loss=loss,
                           train_history=train_history, args=arg_line)

    for epoch in range(start_epoch, args.epochs):
        lr = args.learning_rate
        if args.sgdr:
            lr = cosine_annealing_lr(epoch, args.learning_rate, t_max=10, eta_min=1e-8)
            if writer is not None:
                writer.add_scalar("train/lr", lr, global_step=epoch)

        trainloader.set_epoch(epoch)
        profiler = None
        if args.profile_dir is not None and epoch == start_epoch and grid.is_main:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        train_loss, train_scores = run_train_epoch(
            train_step, trainloader, lr, epoch, metric_names, writer=writer, device=device,
            log_images=not args.light_logging, log_histograms=not args.light_logging)
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, f"{args.experiment}_epoch{epoch}.json")
            profiler.export_chrome_trace(trace)
            print("profiler trace written to", trace)

        valid_loss, valid_scores = run_validate_epoch(eval_step, validloader, epoch, metric_names,
                                                      writer=writer, device=device,
                                                      transform_fn=eval_transform_fn)

        # divergence tripwire: the reference only logs the grad abs-max;
        # abort instead, keeping the last weights for a post-mortem
        if not np.isfinite(train_loss.avg):
            snapshot(snapshot_filename, float("inf"), epoch)
            raise RuntimeError(f"non-finite training loss at epoch {epoch}; "
                               f"snapshot saved to {snapshot_filename}")

        summary = {"epoch": epoch, "loss": train_loss.avg, "val_loss": valid_loss.avg}
        for key, value in train_scores.items():
            summary[key] = value.avg
        for key, value in valid_scores.items():
            summary["val_" + key] = value.avg
        for key, value in summary.items():
            train_history.setdefault(key, []).append(value)
        say(epoch, summary)

        # a new best is written at once (reference torch_train.py:435-438);
        # --snapshot-every gates only the last-epoch snapshot
        if valid_loss.avg < best_loss and args.snapshot_every > 0:
            best_loss = valid_loss.avg
            snapshot(checkpoint_filename, valid_loss.avg, epoch)
            say("Checkpoint saved", epoch, best_loss)
        if args.snapshot_every > 0 and ((epoch + 1) % args.snapshot_every == 0
                                        or epoch == args.epochs - 1):
            snapshot(snapshot_filename, valid_loss.avg, epoch)

    say("Training is finished...")
    if writer is not None:
        writer.close()
    if grid.is_main:
        write_history_csv(os.path.join(experiment_dir, args.experiment + ".csv"), train_history,
                          append=args.resume)
    if distributed and owns_group:
        dist.destroy_process_group()
    return train_history


class _NullWriter:
    """The writer of a rank other than 0: takes every call, writes nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


if __name__ == "__main__":
    main()
