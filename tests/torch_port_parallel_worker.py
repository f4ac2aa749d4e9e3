"""One rank of the parallel tests (tests/test_torch_port_parallel.py).

Run as ``python tests/torch_port_parallel_worker.py <cases.pt> <out dir>``
with torchrun's variables set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); it joins the gloo process group on the CPU, runs every case of
``cases.pt`` and writes ``rank<r>.pt``. Cases:

  * ``step``: LinkNet34 (or the ``narrow`` model: a class of
    ``segtpu_torch.models`` and its arguments, with ``attrs`` such as
    ``s2d`` set) from the given state_dict, ``steps`` training steps on the
    given global batch, under ``model_parallel`` (1: data parallel over
    every rank; ``min_features`` the smallest channel count it shards);
    returns the logs, the full gradients, state_dict and optimizer state,
    and this rank's parameter and moment shapes;
  * ``loader``: this rank's batches of the host loader at each worker count
    and of the ``shapes-device`` loader;
  * ``tile``: tile-parallel ``predict_tiled`` probabilities.
"""

import importlib
import sys

import torch


def _step(case):
    from segtpu_torch.models import get_model
    from segtpu_torch.models.layers import set_data_shard, set_process_group
    from segtpu_torch.ops.losses import get_loss
    from segtpu_torch.ops.metrics import default_metrics
    from segtpu_torch.parallel import make_grid, replicate, shard_batch
    from segtpu_torch.parallel import tensor as tp
    from segtpu_torch.train.optim import get_optimizer
    from segtpu_torch.train.state import make_train_step

    dtype = case["dtype"]
    if "narrow" in case:
        module_name, cls, kwargs = case["narrow"]
        model = getattr(importlib.import_module(module_name), cls)(**kwargs).to(dtype)
    else:
        model = get_model("linknet34", device="cpu").to(dtype)
    model.load_state_dict(case["state_dict"])
    for attr, value in case.get("attrs", {}).items():
        setattr(model, attr, value)
    if not case["dropout"]:
        for m in model.modules():
            if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
                m.p = 0.0
    grid = make_grid(case["model_parallel"])
    if grid.world > 1:
        replicate(model)
    set_process_group(model, grid.data_group)
    set_data_shard(model, grid.data_rank, grid.data_size)
    min_features, tp.MIN_FEATURES = tp.MIN_FEATURES, case.get("min_features", tp.MIN_FEATURES)
    try:
        sharded = tp.shard_model(model, grid)
    finally:
        tp.MIN_FEATURES = min_features
    opt = get_optimizer(case["optimizer"], model.parameters(), case["lr"])
    step = make_train_step(model, opt, get_loss("bce_jaccard"), default_metrics(), seed=3,
                           grid=grid)
    x, y = shard_batch((case["x"].to(dtype), case["y"].to(dtype)), grid)
    logs = [{k: float(v) for k, v in step(x, y, case["lr"]).items()}
            for _ in range(case["steps"])]
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads = {n: tp.gather_shard(g, sharded[n], grid.model_group) if n in sharded else g
             for n, g in grads.items()}
    opt_local = opt.state_dict()["state"]
    return dict(
        logs=logs, grads=grads, sharded=sharded,
        state=tp.full_state_dict(model, sharded, grid) if sharded else model.state_dict(),
        optimizer=(tp.full_optimizer_state(opt, model, sharded, grid) if sharded
                   else opt.state_dict()),
        local_shapes={n: tuple(p.shape) for n, p in model.named_parameters()},
        moment_shapes={i: {k: tuple(v.shape) for k, v in s.items() if v.dim() > 0}
                       for i, s in opt_local.items()})


def _loader(case):
    import numpy as np

    from segtpu_torch.data.pipeline import DataLoader
    from segtpu_torch.data.shapes import DeviceShapesSet, ShapesDataset

    out = {}
    for workers in case["workers"]:
        loader = DataLoader(ShapesDataset(case["n"], case["patch"]), case["batch"], shuffle=True,
                            workers=workers, seed=2, sample_seed=5)
        out[f"host{workers}"] = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            out[f"host{workers}"] += [tuple(np.array(a) for a in b) for b in loader]
    device_loader = DeviceShapesSet(case["n"], case["patch"]).loader(case["batch"], "cpu")
    out["device"] = []
    for epoch in (0, 1):
        device_loader.set_epoch(epoch)
        out["device"] += [tuple(a.clone() for a in b) for b in device_loader]
    return out


def _tile(case):
    from segtpu_torch.inference import predict_tiled
    from segtpu_torch.models import get_model
    from segtpu_torch.parallel import make_grid
    from segtpu_torch.train.state import make_predict_step

    model = get_model("linknet34", device="cpu")
    model.load_state_dict(case["state_dict"])
    grid = make_grid()
    predict = make_predict_step(model)
    return {f"b{b}_tta{int(tta)}": predict_tiled(case["image"], predict, patch_size=case["patch"],
                                               batch_size=b, tta=tta, device="cpu", grid=grid)
            for b, tta in case["runs"]}


KINDS = {"step": _step, "loader": _loader, "tile": _tile}


def main(cases_file: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    import torch.distributed as dist

    from segtpu_torch.parallel.distributed import maybe_initialize_distributed

    assert maybe_initialize_distributed("cpu")
    cases = torch.load(cases_file, weights_only=False)
    results = {name: KINDS[case["kind"]](case) for name, case in cases.items()}
    torch.save(results, f"{out_dir}/rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
