"""The work a configuration's model does, counted from its plain reference on
the meta device (no arithmetic is run), as the configuration files store it:

* ``train_gflop_per_image``: one training step's model FLOPs per image,
  ``FlopCounterMode`` over one forward and backward: the convolutions'
  forward, data gradient and weight gradient (none for the input);
  normalisation, activations, the loss and the optimizer are not counted;
* ``serve_gflop_per_view``: one eval forward of one image;
* ``bn_input_bytes_per_image``: the bytes of every training-BatchNorm input
  (BatchNorm and InPlaceABN) at bf16, as autocast hands them to the kernels;
* ``b2_bytes_per_view``: in eval, each InPlaceABN input read once and its
  output written once at bf16 (the serving sites of kernel B2).

    python3 segbench/counts.py <config>     prints the counts of configs/<config>.json
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from segbench import harness  # noqa: E402
from segbench.reference.numerics import Norm, Numerics  # noqa: E402

BF16 = 2


def count(conf: dict, patch: int) -> dict:
    with torch.device("meta"):
        model = harness.reference_class(conf)(Numerics())
    x = torch.empty(1, 3, patch, patch, device="meta")
    sites = []
    hooks = [m.register_forward_hook(lambda m, i, o: sites.append((m.slope, i[0].numel(),
                                                                     o.numel())))
             for m in model.modules() if isinstance(m, Norm)]
    model.train()
    with FlopCounterMode(display=False) as train:
        model(x).sum().backward()
    bn_bytes = BF16 * sum(n for _, n, _ in sites)
    sites.clear()
    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as serve:
        model(x)
    for h in hooks:
        h.remove()
    b2 = BF16 * sum(i + o for slope, i, o in sites if slope is not None)
    return {"patch": patch, "train_gflop_per_image": train.get_total_flops() / 1e9,
            "serve_gflop_per_view": serve.get_total_flops() / 1e9,
            "bn_input_bytes_per_image": bn_bytes, "b2_bytes_per_view": b2}


def main(argv=None) -> int:
    conf = harness.config((argv or sys.argv[1:])[0])
    print(json.dumps(count(conf, conf["counts"]["patch"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
