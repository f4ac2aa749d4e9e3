"""HBM-traffic floor of FC-DenseNet's concat growth on one GPU (the port's
copy of segtpu's tools/tiramisu_floor.py; pure arithmetic, no device).

    python -m segtpu_torch.tiramisu_floor [--model tiramisu67] [--patch 512] [--batch 4]

Walks FCDenseNet57/67/103 (``segtpu_torch/models/tiramisu.py``
``FCDenseNet57/67/103``) and counts, per training step:

  * the dense-connectivity floor: bytes any implementation of DenseNet's
    semantics must move. Each dense layer reads its whole (growing) concat
    input once forward and once backward, writes its growth output once
    forward and reads its cotangent once backward; the first conv, the
    transitions and the head likewise. No BatchNorm re-reads, no
    materialised concat, no statistics passes: a perfect-fusion lower bound.
  * the concat formulation's extra bytes: each layer writes the new
    ``[prefix | out]`` buffer forward, and its cotangent is written again
    backward before the split (the transition concats too).
  * a designed pass model of BN-ReLU-conv dense layers with perfect fusion
    and no remat.

At the H100's 3.35 TB/s of HBM (NVIDIA's data sheet, SXM at 700 W) each
becomes a step time and an images/s bound, to set beside the measured
``tiramisu67-512-b4`` step (``segtpu_torch.bench``, ``roofline``). The
bytes equal segtpu's tool's for every model, patch and batch; its times
used the TPU's rate.
"""

from __future__ import annotations

import argparse
import json

HBM_GBS = 3350.0

ARCH = {
    # (down_blocks, up_blocks, bottleneck_layers, growth, first_conv)
    "tiramisu57": ((4,) * 5, (4,) * 5, 4, 12, 48),
    "tiramisu67": ((5,) * 5, (5,) * 5, 5, 16, 48),
    "tiramisu103": ((4, 5, 7, 10, 12), (12, 10, 7, 5, 4), 15, 16, 48),
}


def analyze(model: str, patch: int, batch: int, bpe: float = 2.0,
            hbm_gbs: float = HBM_GBS) -> dict:
    """The floors of one training step of ``model`` at ``patch`` and
    ``batch`` with ``bpe`` bytes per element, unrounded; times at
    ``hbm_gbs`` GB/s."""
    down, up, bott, g, first = ARCH[model]
    hw0 = patch * patch
    floor = extra = chain = designed = 0.0  # elements times passes

    def conv_io(cin, cout, hw_in, hw_out):
        # input read and output written forward; cotangent read and dx
        # written backward (the weight gradient's bytes are negligible)
        return (cin * hw_in + cout * hw_out) * 2

    def dense_block(c0, n, hw, upsample):
        nonlocal floor, extra, chain, designed
        c = c0
        for _ in range(n):
            layer = (c * hw) * 2 + (g * hw) * 2
            floor += layer
            chain += layer
            extra += ((c + g) * hw) * 2
            chain += ((c + g) * hw) * 2
            # forward: statistics read (c), normalise read and write (2c),
            # conv read (c), growth write (g), concat write (c + g);
            # backward: dgrad write (c), dx chain (3c), statistics reads (2c),
            # growth cotangent (2g)
            designed += (9 * c + 3 * g + (c + g)) * hw
            c += g
        return c if not upsample else n * g

    c = first
    floor += conv_io(3, first, hw0, hw0)
    hw = hw0
    skips = []
    for n in down:
        c = dense_block(c, n, hw, upsample=False)
        skips.append((c, hw))
        floor += conv_io(c, c, hw, hw)  # transition down: 1x1 conv
        floor += (c * hw) * 1.5  # its pool: read hw, write hw / 4 twice
        hw = hw // 4

    c_up = dense_block(c, bott, hw, upsample=True)
    for i, n in enumerate(up):
        skip_c, skip_hw = skips.pop()
        floor += conv_io(c_up, c_up, hw, skip_hw)  # transition up (deconv)
        hw = skip_hw
        cin = c_up + skip_c
        extra += (cin * hw) * 2
        chain += (cin * hw) * 2
        last = i == len(up) - 1
        out_c = dense_block(cin, n, hw, upsample=not last)
        c_up = out_c if not last else cin + n * g
    floor += conv_io(c_up, 1, hw, hw)  # head

    to_gb = batch * bpe / 1e9
    floor_gb, concat_gb, chain_gb = floor * to_gb, extra * to_gb, chain * to_gb
    # the designed total: the pass model's dense layers plus the floor's
    # non-dense remainder
    non_dense = floor - (chain_gb / to_gb - extra)
    designed_gb = (designed + non_dense) * to_gb

    def ms(gb):
        return gb / hbm_gbs * 1e3

    return {
        "model": model, "patch": patch, "batch": batch, "hbm_gbs": hbm_gbs,
        "floor_gb_per_step": floor_gb,
        "floor_step_ms_at_hbm_rate": ms(floor_gb),
        "floor_img_per_s_bound": batch / ms(floor_gb) * 1e3,
        "concat_materialization_gb": concat_gb,
        "concat_chain_total_gb": chain_gb,
        "floor_plus_concat_gb": floor_gb + concat_gb,
        "floor_plus_concat_img_per_s": batch / ms(floor_gb + concat_gb) * 1e3,
        "designed_pass_model_gb": designed_gb,
        "designed_pass_model_img_per_s": batch / ms(designed_gb) * 1e3,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="tiramisu67", choices=sorted(ARCH))
    ap.add_argument("--patch", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bytes-per-elem", type=float, default=2.0)
    ap.add_argument("--hbm-gbs", type=float, default=HBM_GBS)
    args = ap.parse_args(argv)
    print(json.dumps(analyze(args.model, args.patch, args.batch, args.bytes_per_elem,
                             args.hbm_gbs), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
