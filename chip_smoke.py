"""Smoke run of the PyTorch/CUDA port (``segtpu_torch``) on one GPU.

    python3 chip_smoke.py [--ab-out DIR]

Phases, one JSON line each; any failure exits non-zero:

  device       the card (nvidia-smi name and power limit), torch and CUDA versions,
               and which of pandas, tqdm, tensorboardX, cv2, sklearn, ninja,
               matplotlib and msgpack the machine can import
  build        nvcc build of every CUDA kernel of segtpu_torch/csrc, in seconds,
               and each kernel's registers and spills from ptxas -v
  kernel_b1    the channel-sums kernel against its plain PyTorch version
               (fp32/bf16, channels_last/NCHW/[M, C], single and pair forms, a
               ragged M, C = 37, then every BatchNorm and InPlaceABN input shape
               of one training step of LinkNet34, ZF_UNET, UNetABN and AlbuNet
               at batch 16 and of tiramisu67 and tiramisu57 at batch 4, patch
               512), with its time, bytes, bound and torch.var_mean's time at
               the largest shape (tiramisu67's 4x272x512^2) and at each model's
               largest; its time cold in L2 at each distinct shape and form,
               and a model of its time per step of each model: each of those
               times its calls per step (84, 44, 18, 72, 120, 98), against
               their summed bound (var_mean's sum over the single-form calls
               beside it); at every timed shape and per modelled step also
               one PyTorch call for each form, checked against B1's sums
               by B1's gate first and reported, not gated:
               torch.batch_norm_stats beside var_mean for the single form,
               torch.batch_norm_backward_reduce (mean 0, invstd 1: its
               sum_dy and sum_dy_xmu) for the pair form; tiramisu57's calls that take the scalar-load plan
               (C not a multiple of 8) apart; and two calls giving the same
               bits at the largest and the smallest step shape; and in fp32
               channels_last, both forms at every BatchNorm and InPlaceABN
               shape of the nuclei A/B's fp32 steps (LinkNet34 and ZF_UNET
               at batch 8, patch 128) and of the zoo's parity steps (2 x 3
               x 64^2), checked, not timed. The model zoo's steps (ZOO_BATCH:
               batch 16, or 8 over ResNet-101/152, patch 512): every
               BatchNorm shape checked in both forms, each model's largest
               timed beside torch.var_mean, and psp_net's and duc's calls
               modelled per step (PSPNet's pyramid at 8 to 288 rows among
               them). Times are
               device times (segtpu_torch.profile_reduce.cuda_ms: a spin
               kernel keeps the device busy while the host launches)
  kernel_b3    the from-output ABN backward kernel against its plain version
               (the same cases, three activations, then the InPlaceABN shapes
               of LinkNet34's and UNetABN's steps), with its time, bytes and
               bound at the largest and at LinkNet34's largest, the same
               per-shape times and per-step models (12 and 18 calls), the
               repeat check, and LinkNet34's InPlaceABN shapes of the nuclei
               A/B's fp32 steps in fp32 channels_last
  kernel_b2    the fused BN+activation kernel against its plain PyTorch version
               (fp32/bf16, three activations, the edge cases of its launch
               plan in channels_last, NCHW, unaligned NCHW and unaligned
               channels_last: C = 37, C = 12 and 268 (C = 4 mod 8, M not a
               multiple of the period, a ragged element tail), C = 1024 and
               a row-major [1499, 37]; the twelve decoder shapes of a
               LinkNet34 pass at tile batch 64, the BatchNorm and
               InPlaceABN shapes of every model's step above, and in fp32
               channels_last those of the nuclei A/B's steps, none and
               leaky_relu), with its time, bytes and bound at the largest
               shape, at each model's largest training shape, and modelled
               per step as kernel_b1; beside its activation-none form (the
               BatchNorm affine) one PyTorch call that computes it,
               F.batch_norm over mean 0, variance 1 (eps 1e-12), held to
               B2's bf16 gate and timed at 4x272x512^2, 16x32x512^2 and
               16x64x256^2 and per step, as torch.var_mean beside B1; fails
               where B2 is not faster than F.batch_norm at one of those
               shapes (warm medians of 20) or over a model's modelled
               activation-none calls per step. Then B2 and F.batch_norm
               over C = 32, 64, 128, 272, 512, 1024 at a fixed 570 MB of
               bf16 channels_last input, each with its share of the bound.
               The zoo's BatchNorm shapes as in kernel_b1, in bf16 and at
               the parity steps in fp32; each zoo model's largest and
               psp_net's and duc's per-step calls timed beside
               F.batch_norm, reported and not gated
  kernel_s2d   B1 (both forms), B2 (none, leaky_relu) and B3 against their
               plain versions at the normalisation inputs of the s2d forms'
               steps (grouped statistics: zf_unet and UNetABN at batch 16,
               tiramisu67 and tiramisu57 at batch 4 with their block-wise
               4 x (48 + 16k) and 4 x (48 + 12k) channels, LinkNext's stem)
               that the earlier phases did not check, bf16 channels_last;
               each s2d form's largest shape timed beside the plain
               versions, torch.var_mean, torch.batch_norm_backward_reduce
               and F.batch_norm
  model_parity LinkNet34 saved and reloaded through the .pth snapshot format,
               one 2x3x512x512 fp32 eval forward on the card vs the CPU
  serve        tiled inference as the submit CLI runs it (patch 512, batch 64,
               D4 TTA, pyramid weights, threshold 0.5, bf16, depth 2) over two
               seeded 5000x5000 uint8 images after one warm image; s/image,
               peak memory and kernel launches, plus bf16-vs-fp32 masks and a
               small-image card-vs-CPU parity check
  train_parity one fp32 LinkNet34 training step (SGD, dropout off, TF32 off) on
               2x3x128x128 SHAPES, card against CPU: loss, every gradient,
               running statistics and the parameters after the step
  train        the training path at full width: LinkNet34, batch 16, patch
               512, bf16 autocast, bce_jaccard, Adam lr 1e-3, one fixed
               DeviceShapes batch, 3 warm steps then 20 timed ones; images/s,
               ms/step, peak memory, first and last loss, and the launches of
               B1, B2 and B3 per step against the layer count
  train_dp     data parallel, two processes on the one card over gloo (NCCL
               refuses two ranks on one device): LinkNet34 at config #2's
               global batch 16, patch 512, 8 samples per rank, sync
               BatchNorm over B1/B2/B3; (a) one fp32 Adam step (TF32 off,
               dropout on) against one process on the same 16 by PARITY_TOL
               (loss rtol 1e-5; gradient errors median <= 5e-3, max <= 0.1 of
               max |g|; running statistics to 1e-5; parameters within Adam's
               update bound) and the layer count of launches per rank; then
               3 warm and 5 timed bf16 steps per rank, ms/step and launches
               per rank (two ranks on one card measure correctness and
               overhead, not scaling)
  train_tp     --model-parallel 2 as the same two processes: the same fp32
               step and gates against one process, and the parameters each
               rank holds (sharded tensors, local count below 0.6 of the
               model's)
  serve_tile_parallel  the same two processes serve the seeded 5000^2
               image tile-parallel: fp32 probabilities (TF32 off) within
               1e-4 of one process's, then bf16 s/image at config #5 with
               B2's launches per rank
  train_dp_cli train_dp (b): one rank through the train CLI's own NCCL start,
               the launcher variables set (world 1), 4 shapes-device steps
  serve_ckpt   random torchvision-format ResNet-34 encoder weights in
               LinkNet34, written as segtpu's .ckpt directory (the port's
               writer): the card's model loaded as submit_cli loads it
               (--encoder-weights, then -c <dir>.ckpt) against the CPU's from
               a .pth of the same weights (fp32 logits, atol 1e-3); then
               submit_cli itself on one 1024^2 image, B2's launches counted
  serve_host_slice  one seeded 5000x5000 image as serve runs it, with the tiles
               cut on the host (native tile I/O, slice_on_device=False) and
               on the device in turns: the native extractor cut both host
               runs' tiles (no NumPy fallback), probabilities within 1e-6, s/image
               of each, B2's launches, the native split's and NumPy's
               seconds; then LinkNet34's s2d head on a 1024^2 crop against
               normal space (fp32 within 1e-4, bf16 mask agreement)
  zf_unet_parity  full-width ZF_UNET: one 1x3x256x256 fp32 eval forward on the
               card (TF32 off) vs the CPU, then one fp32 SGD bce training step
               on 2x3x128x128 SHAPES (dropout off), card against CPU and
               against float64, with train_parity's gates. Every parity phase
               holds each updated parameter to the largest move of the
               optimizer's step that a gradient error within the gradient
               gate can cause (SGD: lr x 0.1 x the tensor's gradient scale),
               plus 1e-7
  train_zf_unet   segtpu's default bench config zf_unet-512 (full width, batch
               16, patch 512, bf16 autocast, bce, SGD lr 1e-3): 3 warm steps
               then 20 timed, as train; launches per step (44, 22, 0), no copy
               of a BatchNorm input, the upsampling left in bf16 by
               autocast; then 3 steps with --remat's
               rematerialisation, printing their launches, with the running
               statistics updated once per step
  train_unet_abn  full-width UNetABN, batch 16, patch 512, bf16, bce_jaccard,
               Adam: 3 warm and 5 timed steps, launches per step (18, 18, 18);
               then 2 UNet steps (bce, SGD), launches per step (36, 18, 0)
  tiramisu_parity  full-width tiramisu67: the eval forward at 1x3x128x128, then
               one SGD bce step on 2x3x64x64 SHAPES, as zf_unet_parity;
               launches 120/60/0
  train_tiramisu67  the bench config tiramisu67-512-b4 (batch 4, patch 512,
               bf16, bce, SGD lr 1e-3): 3 warm then 10 timed steps, launches per
               step (120, 60, 0), no copy of a BatchNorm input; then 3 steps
               under --remat with the running statistics updated once per step
  albunet_parity  full-width AlbuNet: the eval forward at 1x3x128x128, then one
               Adam bce step with the encoder frozen on 2x3x64x64 SHAPES;
               launches 72/36/0, the frozen parameters keep their bits, the
               encoder's running statistics move
  train_albunet   the bench config albunet-finetune-512 (batch 16, patch 512,
               bf16, bce, Adam, encoder frozen): 3 warm and 5 timed steps,
               launches per step (72, 36, 0), frozen parameters unchanged
  train_unet11    the bench config unet11-finetune-512 in normal space (VGG
               stages frozen): 3 warm and 5 timed steps, no kernel of this
               repo (0, 0, 0); then 2 UNet16 steps
  s2d_parity   one fp32 SGD step of full-width ZF_UNET and UNetABN in s2d form
               on 2x3x128x128 SHAPES: card against CPU and float64 by
               PARITY_TOL, launches the layer count, and against the card's
               normal-space step by the same gates
  train_s2d    segtpu's s2d bench form of zf_unet-512 and unet11-finetune-512,
               and UNetABN, at batch 16, patch 512, bf16: normal, s2d, s2d,
               normal, each 3 warm and 5 timed steps; ms/step, images/s,
               peak memory, launches per step the layer count, forward conv
               GFLOP per image of each form
  train_tiramisu_a18  tiramisu67-512-b4 with packed growth, remat_policy
               "conv_in", both, between two concat runs: ms/step, images/s,
               peak memory, launches per step (120, 60, 0; conv_in 175, 115,
               0), packed's copies of BatchNorm inputs, running statistics
               updated once per step
  zoo_parity   the model zoo at full width (dilated_linknet34, gcn34, linknext,
               squeezenet, gcn, psp_net, duc, duc_dc): per model one fp32
               eval forward on the card (TF32 off) at 1x3x128^2 (1x3x64^2
               over ResNet-101/152), calibrated on the CPU, against the CPU
               in fp32 and float64; one fp32 SGD bce step on 2x3x64x64
               SHAPES (dropout off) on the card, the CPU in NCHW and in
               channels_last, and the CPU in float64. The card is held to
               float64 by train_parity's gates, or by 4x the CPU fp32 runs'
               own distance from float64 where that is larger (the deep
               steps are ill-conditioned at this size); launches per step
               as the layer count (B3 0 in all eight); PSPNet's head
               BatchNorms at momentum 0.95
  train_zoo    each zoo model at patch 512, bf16 autocast, bce, SGD lr 1e-3
               on one fixed DeviceShapes batch (16, or 8 over ResNet-101/
               152): 3 warm and 3 timed steps; images/s, ms/step, peak
               memory, losses (finite; whether the last is below the first
               is reported, not gated), launches per step as the layer
               count, no copy of a BatchNorm input; the dtype of the
               bilinear upsampling under autocast, and gcn's and psp_net's
               steps with it kept in bf16
  train_cli_psp_net  the train CLI's -m psp_net -d shapes-device -s 2 -e 1
               --bf16 at batch 8: launches 2 x (218, 109, 0), the two .pth
  serve_zoo    the submit CLI's path (predict_tiled_stream) with
               DilatedLinkNet34 over one seeded 5000x5000 image (patch 512,
               tile batch 64, D4 TTA, bf16): s/image, a 0/255 mask, no
               kernel of this repo (eval-mode BatchNorm is F.batch_norm)
  wider_resnet one fp32 SGD step (cross-entropy, 10 classes) of
               WideResNet-28-10 at 32x3x32x32, seeded, card (TF32 off)
               against the CPU and float64 by train_parity's gates;
               launches (50, 25, 0), its 25 BatchNorms
  train_cli    the train CLI in process, in a temporary directory, three runs:
               (a) -d shapes-device -b 16 -p 512 --bf16 -o adam -e 2 (64 train
               steps and 8 validation batches an epoch), (b) -e 3 -r on the
               same directory (resumes after the best epoch), (c) the host
               loader, -d shapes -w 4 -s 4 -e 1. Per run: B1/B2/B3 launches
               against train steps x (84, 48, 12) + validation batches x the
               eval pass's (0, 12, 0), images/s over the train epochs and
               over whole epochs, ms/step against the train phase's, peak
               memory; the share of epoch 2 of (a) that the device spends
               outside the steps (a CUDA event pair around each step); the
               host loader's own samples/s; the host's waits for the card in
               each train epoch (torch's sync debug mode: at most the
               epoch's log fetch, none per step); the CSV and both .pth
               files, the best one restored with its optimizer state
  train_ab_cli the afterburner CLI in process, one shapes-device epoch of 8
               steps on the frozen head that train_cli's run (a) wrote:
               launches against steps x (120, 66, 12) + validation batches x
               (0, 12, 0); the head's parameters as loaded, its running
               statistics and every afterburner parameter moved
  train_cli_albunet  the train CLI's albunet --freeze-encoder -d shapes-device
               -s 2 -e 1 at batch 16, patch 512, bf16, Adam: launches 2 x (72,
               36, 0); the last .pth holds the encoder as initialised
  augment_parity  every op and the three pipelines of
               segtpu_torch.augment.device on the card against the CPU, the
               same parameters on 16x3x512x512 fp32 0-255 pixels: bit-equal
               flips, rot90, transpose, crops, invert, grayscale, normalize
               and the shapes pipeline; warps 1e-2 on the 0-255 scale (masks
               1e-2/255, binarised masks differing only within 1e-3 of the
               threshold); brightness, contrast, saturation, filter 1e-4;
               HSV 1e-3; CLAHE at most 1 grey level on 0.1% of pixels; each
               pipeline's device ms per batch beside the train phase's
               LinkNet34 step; no kernel of this repo launched
  train_cli_device_augs  the train CLI's -d shapes --device-augs (linknet34,
               batch 16, patch 512, bf16, Adam, -s 8): 2 epochs; 1 epoch in a
               new directory, then -r -e 2 there, whose epoch draws the
               unbroken run's second epoch (each step's generator seed, the
               sums of the augmented batches) and whose loss is the unbroken
               epoch's to RESUME_RTOL (dropout keyed by step, cuDNN
               deterministic); launches per
               step the layer count, host waits per train epoch, losses
               finite and falling
  lr_finder    segtpu_torch.lr_finder's main, in process, -m linknet34 -d
               shapes-device (batch 16, patch 512, Adam): 30 finite losses
               and the PNG
  train_nuclei the accuracy A/B of python -m segtpu_torch.ab_nuclei: the
               seeded nuclei fixture (48 images) in the DSB2018 layout, the
               train CLI's -d dsb2018 legs at patch 128, batch 8, fp32, 10
               epochs, zf_unet (bce, SGD lr 1e-3) and linknet34 (bce_jaccard,
               Adam lr 1e-4), run seeds 20260819-21, each leg a train_cli
               run with its launches (44/22/0 and 84/48/12 per step, the
               eval pass's per validation batch), under ab_nuclei's
               reference precision (TF32 off, cuDNN deterministic); one line
               per config with the port's, torch's and segtpu's val-IoU
               bands per epoch, the final mean deltas, steps/s, the host
               loader's samples/s, the TF32 and determinism flags the legs
               ran with and cv2's version; fails when the port's band lies
               below the committed torch band at an epoch of the second
               half or a leg ran with TF32 on. Then the first two epochs of
               linknet34's first leg again, and whether their losses and
               val IoU repeat the leg's bits. --ab-out writes comparison.md
               and the port's CSVs
  ladder_l0    segtpu_torch.ab_ladder's L0 leg (augmentations, shuffle and
               dropout off; the nuclei fixture, linknet34 at patch 128,
               batch 8, fp32, TF32 off, cuDNN deterministic) for one epoch
               cut to 16 train steps, twice: both write the same CSV bit
               for bit; the ladder's switches and the precision flags are
               restored after
  train_nuclei_device_augs  the nuclei fixture's -d dsb2018 (linknet34,
               patch 128, batch 8, fp32, Adam lr 1e-4): 1 epoch with the
               host augmentations and 2 with --device-augs, images/s of
               each; then the resumed run's draws, as train_cli_device_augs
  bench_all    python -m segtpu_torch.bench --all through bench.run_config:
               the five training configs at 3 warm and 5 timed steps (their
               launches (3 + 5) x the layer count) and
               inria-tiled-inference-5000 at one image and one repeat (B2
               552 per image, warm image included); its s/image within 10%
               of serve's (both predict_tiled_stream at depth 2)
  roofline     segtpu_torch.roofline on linknet34-bce_jaccard-adam-512 and
               zf_unet-512 in s2d and normal form (10 timed steps): model
               GFLOP per step, ms/step, TFLOP/s, mfu_pct in (0, 100], the two
               zf_unet forms' GFLOP equal, the ops' bytes; launches (2 + 3 +
               10) x the layer count (the FLOP count's step and the byte
               count's step included)
  tiled_floor  config #5's bound (segtpu_torch.tiled_floor): 2888 model
               passes of one forward's FLOPs, the merge's bytes, the pinned
               transfers; fails if the floor exceeds serve's s/image
  bn_sol       segtpu_torch.bn_sol on linknet34-bce_jaccard-adam-512: the 48
               BatchNorm/InPlaceABN sites, 3x their bytes at 3.35 TB/s, the
               step and its B1/B3 time from profile_train (a profiler
               session: it runs after the other new phases)
  counters     after training, every cached counter buffer of the B1/B3
               reduction holds zeros
  one_launch   a torch.profiler count: one call of B1 (either form), B2 or
               B3 runs exactly one device kernel, at the step's largest and
               smallest shapes (a profiler session slows later launches)
  cli_profile  last: the train CLI's --profile-dir trace of one shapes-device
               epoch of 8 steps; the device's idle share over it (the union
               of its kernels and copies against the epoch's span)

The kernel counts are set to 0 just before each main path (serve, train,
train_zf_unet, train_unet_abn, train_tiramisu67, train_albunet,
train_unet11, each train_zoo model's timed steps, train_cli_psp_net,
serve_zoo, wider_resnet's card step, each train_cli run, train_ab_cli,
train_cli_albunet, each train_cli_device_augs run, each train_nuclei leg,
each train_nuclei_device_augs run, each rank's train_dp timed steps,
train_tp step and serve_tile_parallel bf16 pass, train_dp_cli, serve_ckpt's
submit_cli run, serve_host_slice's second host-sliced image, train_s2d's s2d
runs, train_tiramisu_a18's packed and conv_in runs, ladder_l0's legs, each
bench_all config, each roofline run, tiled_floor, bn_sol) and read just
after it. Then the kernel table line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Weights are random, drawn from a seed,
with the normalisation statistics set from one calibration batch so that every
layer sees activations of order one.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist

from segtpu_torch import (ab_ladder, ab_nuclei, bench, bn_sol, lr_finder, native, roofline,
                          submit_cli, tiled_floor, train_ab_cli, train_cli)
from segtpu_torch.compat.encoder_weights import install_encoder_weights
from segtpu_torch.augment import host as aug
from segtpu_torch.data import get_dataset
from segtpu_torch.data.inria import INRIA_MEAN, INRIA_STD
from segtpu_torch.data.pipeline import DataLoader, Subset
from segtpu_torch.data.shapes import DeviceShapes, ShapesDataset, to_nchw
from segtpu_torch.inference import predict_tiled, predict_tiled_stream
from segtpu_torch.models import ENCODER_PREFIXES, get_model, without_encoder
from segtpu_torch.models import layers as layers_mod
from segtpu_torch.models.encoders.resnet import resnet34
from segtpu_torch.models.layers import (BatchNormTorch, InPlaceABN, set_data_shard,
                                        set_process_group, upsample_nearest)
from segtpu_torch.ops import abn as abn_ops
from segtpu_torch.ops import kernels
from segtpu_torch.ops.abn import abn_bwd_sums_plain, abn_norm_act_plain, channel_sums_plain
from segtpu_torch.ops.losses import get_loss
from segtpu_torch.ops.metrics import default_metrics
from segtpu_torch.profile_reduce import NORM_LAYERS, L2_FLUSH_BYTES, cuda_ms, step_norm_shapes
from segtpu_torch.parallel import Grid, make_grid, replicate, shard_batch
from segtpu_torch.parallel import tensor as tensor_parallel
from segtpu_torch.parallel.distributed import maybe_initialize_distributed
from segtpu_torch.train.checkpoint import (load_snapshot, restore_snapshot, save_flax_snapshot,
                                           save_snapshot)
from segtpu_torch.train.optim import get_optimizer
from segtpu_torch.tiles import ImageSlicer
from segtpu_torch.train.state import make_predict_step, make_train_step

SEED = 0
PATCH, BATCH, IMAGE_SIDE, N_IMAGES, DEPTH = 512, 64, 5000, 2, 2
SLOPE = 0.01
TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS = 16, 1e-3, 3, 20
# tiramisu67-512-b4 (segtpu bench.py:217-219): batch 4, 10 timed steps
TIRAMISU_BATCH, TIRAMISU_STEPS = 4, 10


def step_launches(n_bn: int, n_abn: int) -> dict:
    """Launches per training step of a model with ``n_bn`` BatchNorm and
    ``n_abn`` InPlaceABN layers: B1 for each BatchNorm forward and backward
    and each InPlaceABN forward; B2 for the affine of each BatchNorm and each
    InPlaceABN; B3 for each InPlaceABN backward."""
    return {"channel_sums": 2 * n_bn + n_abn, "abn_norm_act": n_bn + n_abn, "abn_bwd": n_abn}


# LinkNet34 84, 48, 12; ZF_UNET 44, 22, 0; UNet 36, 18, 0; UNetABN 18, 18, 18;
# tiramisu67 120, 60, 0; tiramisu57 98, 49, 0; AlbuNet 72, 36, 0; UNet11 0, 0, 0
MODEL_STEP_LAUNCHES = {name: step_launches(*n) for name, n in NORM_LAYERS.items()}
STEP_LAUNCHES = MODEL_STEP_LAUNCHES["linknet34"]
# Launches per eval-mode pass: B2 in the 12 InPlaceABN layers; eval-mode
# BatchNorm is F.batch_norm over the running statistics and runs no kernel of
# this repo, and nothing is reduced.
EVAL_LAUNCHES = {"channel_sums": 0, "abn_norm_act": 12, "abn_bwd": 0}
NO_LAUNCHES = {"channel_sums": 0, "abn_norm_act": 0, "abn_bwd": 0}
# The models whose training-step shapes the kernel phases check and time, at
# the batch of their step. tiramisu57 grows by 12 channels, so most of its
# B1 calls take the kernel's scalar loads (vec 1).
KERNEL_MODELS = {"linknet34": TRAIN_BATCH, "zf_unet": TRAIN_BATCH, "unet_abn": TRAIN_BATCH,
                 "tiramisu67": TIRAMISU_BATCH, "tiramisu57": TIRAMISU_BATCH,
                 "albunet": TRAIN_BATCH}
# The model zoo: each model's training batch at patch 512 (8 over
# ResNet-101/152), and the side of its fp32 eval parity forward (64 over
# ResNet-101/152, else 128). The kernel phases check every BatchNorm shape
# of each zoo step, time each model's largest, and model B1's and B2's time
# per step of ZOO_PER_STEP as of KERNEL_MODELS.
ZOO_BATCH = {"dilated_linknet34": 16, "gcn34": 16, "linknext": 16, "squeezenet": 16,
             "gcn": 8, "psp_net": 8, "duc": 8, "duc_dc": 8}
ZOO_SIDE = {m: 64 if b == 8 else 128 for m, b in ZOO_BATCH.items()}
ZOO_STEPS = 3
ZOO_PER_STEP = ("psp_net", "duc")
# Zoo models with a bilinear upsampling in their head, by the module that
# calls it: their step is also timed with it kept in bf16 (autocast runs it
# in fp32, as segtpu does).
ZOO_BILINEAR = {"gcn": "segtpu_torch.models.gcn", "psp_net": "segtpu_torch.models.psp"}
CLI_ARGS = ["-m", "linknet34", "-l", "bce_jaccard", "-o", "adam", "-lr", "1e-3", "-b", str(TRAIN_BATCH),
            "-p", str(PATCH), "--bf16", "--no-tensorboard", "--seed", "0"]
# Host waits for the card allowed in a train epoch: the loop's one log fetch
# at the epoch's end copies each of its 4 logs; one wait per step would give
# 64 in a shapes-device epoch.
EPOCH_SYNCS = 8
# Train steps and validation batches of one shapes-device epoch: 1024 and
# 128 samples.
CLI_STEPS, CLI_VAL_BATCHES = 1024 // TRAIN_BATCH, 128 // TRAIN_BATCH
# The main paths, and those that run each kernel. train_unet11 runs none:
# TernausNet has no normalisation layer.
PATHS = ("serve", "train", "train_zf_unet", "train_unet_abn", "train_tiramisu67", "train_albunet",
         "train_unet11", "train_zoo", "train_cli_psp_net", "serve_zoo", "wider_resnet",
         "train_cli", "train_ab_cli", "train_cli_albunet", "train_cli_device_augs",
         "train_nuclei", "train_nuclei_device_augs", "train_dp", "train_dp_cli", "train_tp",
         "serve_tile_parallel", "serve_ckpt", "serve_host_slice", "train_s2d",
         "train_tiramisu_packed", "train_tiramisu_conv_in", "ladder_l0", "bench_all", "roofline",
         "tiled_floor", "bn_sol")
BN_PATHS = ("train_zf_unet", "train_tiramisu67", "train_albunet", "train_zoo",
            "train_cli_psp_net", "train_cli_albunet", "wider_resnet", "train_tiramisu_packed",
            "train_tiramisu_conv_in")
# train_s2d's s2d runs: ZF_UNET's BatchNorms and UNetABN's InPlaceABNs
ABN_PATHS = ("train", "train_unet_abn", "train_cli", "train_ab_cli", "train_nuclei",
             "train_cli_device_augs", "train_nuclei_device_augs", "train_dp", "train_dp_cli",
             "train_tp", "train_s2d", "ladder_l0", "bench_all", "roofline", "bn_sol")
KERNEL_PATHS = {
    "channel_sums": ABN_PATHS + BN_PATHS,
    "abn_norm_act": ("serve", "serve_tile_parallel", "serve_ckpt", "serve_host_slice",
                     "tiled_floor")
                    + ABN_PATHS + BN_PATHS,
    "abn_bwd": ABN_PATHS}
OPTIONAL_PACKAGES = ("pandas", "tqdm", "tensorboardX", "cv2", "sklearn", "ninja", "matplotlib",
                     "msgpack")
# Channel sums of fp32 terms, added in two orders: |err| <= RTOL_SUM * sum |term|.
RTOL_SUM = 1e-5

# Device-memory rate (bytes/s) and fp32 CUDA-core rate (FLOP/s) by card name,
# from NVIDIA's data sheets; the first matching key wins.
CARD_RATES = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)


# The script's start, for the seconds since it of each phase line.
STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": round(time.perf_counter() - STARTED, 1)}), flush=True)


def card_rates(name: str):
    for key, bw, flops in CARD_RATES:
        if key in name:
            return bw, flops, key
    return 3.35e12, 67e12, "unknown card: H100 SXM rates assumed"


def decoder_abn_shapes(batch: int, patch: int):
    """Input shapes of the twelve InPlaceABN layers of one LinkNet34 pass, in
    order (decoder4 .. decoder1; abn1, abn2, abn3 each)."""
    shapes, s = [], patch // 32
    for cin, cout in ((512, 256), (256, 128), (128, 64), (64, 64)):
        mid = cin // 4
        shapes += [(batch, mid, s, s), (batch, mid, 2 * s, 2 * s), (batch, cout, 2 * s, 2 * s)]
        s *= 2
    return shapes


def calibrate_norms(model: torch.nn.Module, x: torch.Tensor) -> None:
    """Set every BN/ABN layer's running statistics to the per-channel mean and
    variance of its input on ``x``, in one forward pass."""
    def hook(mod, inp):
        t = inp[0].float()
        mod.running_mean.copy_(t.mean((0, 2, 3)))
        mod.running_var.copy_(t.var((0, 2, 3)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (BatchNormTorch, InPlaceABN))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()


def importable(names):
    """{name: True/False}: whether a fresh interpreter imports each module."""
    code = ("import importlib, json, sys\n"
            "ok = {}\n"
            "for n in sys.argv[1:]:\n"
            "    try:\n"
            "        importlib.import_module(n); ok[n] = True\n"
            "    except Exception:\n"
            "        ok[n] = False\n"
            "print(json.dumps(ok))\n")
    out = subprocess.run([sys.executable, "-c", code, *names], capture_output=True, text=True,
                         check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(), python=sys.version.split()[0],
         importable=importable(OPTIONAL_PACKAGES))
    return name, smi


def _short_kernel_name(mangled: str, demangled: str) -> str:
    """``rows_kernel<__nv_bfloat16, 8, true, 2, AbnBwdOp<1> >`` from the
    demangled signature, or the mangled name where c++filt is missing."""
    if not demangled or demangled == mangled:
        return mangled
    name = demangled.replace("(anonymous namespace)::", "").replace("chred::", "")
    return re.sub(r"^void ", "", name).split("(", 1)[0]


def ptxas_report(log: str):
    """One entry per kernel of an ``nvcc -Xptxas -v`` log: its name,
    registers and spill bytes."""
    entries, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"mangled": m.group(1), "spill_stores": 0, "spill_loads": 0}
            entries.append(current)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(e["mangled"] for e in entries),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        for e, d in zip(entries, out):
            e["name"] = _short_kernel_name(e["mangled"], d.strip())
    for e in entries:
        e.setdefault("name", e["mangled"])
        del e["mangled"]
    return entries


def phase_build():
    t0 = time.perf_counter()
    paths = kernels.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in paths:
        log = kernels.BUILD_DIR / f"{name}.log"
        ptxas[name] = ptxas_report(log.read_text()) if log.exists() else []
        if not ptxas[name]:
            raise AssertionError(f"build: no ptxas report for {name}")
    emit("build", seconds=seconds, libraries=[str(p.name) for p in paths.values()], ptxas=ptxas)
    return ptxas


def _check(x, scale, shift, act, tol):
    got = kernels.abn_norm_act_cuda(x, scale, shift, act, SLOPE)
    want = abn_norm_act_plain(x, scale, shift, act, SLOPE)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != x.dtype or got.stride() != x.stride():
        raise AssertionError(f"abn_norm_act output {got.shape} {got.dtype} {got.stride()} "
                             f"vs input {x.shape} {x.dtype} {x.stride()}")
    err = (got.float() - want.float()).abs()
    rtol, atol = tol
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"abn_norm_act disagrees with its plain version: {x.dtype} "
                             f"{tuple(x.shape)} {act}: max err {err.max().item()}")
    return err.max().item()


class fp32_convolutions:
    """TF32 off for cuDNN and matmuls inside the block; these flags and
    ``cudnn.enabled`` are restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.enabled)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.enabled) = self.saved


def timing_entry(nbytes: int, ops: int, card: str, **times) -> dict:
    """Bytes, bound and times of one kernel at one shape; the bound is the
    larger of bytes over the memory rate and operations over the fp32 rate."""
    bw, flops, _ = card_rates(card)
    t_bytes, t_ops = nbytes / bw, ops / flops
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations", **times)


def in_layout(x, layout):
    """``x`` as channels_last, nchw (contiguous; a 2-D tensor is [M, C]),
    unaligned (contiguous, one element off a 16-byte boundary, so the
    kernels take their scalar path) or unaligned_channels_last (the same in
    channels_last)."""
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    if layout == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        return buf[1:].view(x.shape).copy_(x)
    if layout == "unaligned_channels_last":
        n, c, h, w = x.shape
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        return buf[1:].view(n, h, w, c).permute(0, 3, 1, 2).copy_(x)
    return x


def cuda_input(shape, dtype, layout, g, mean=0.3, std=2.0):
    """A seeded tensor on the card in ``layout`` (see :func:`in_layout`)."""
    return in_layout((torch.randn(shape, device="cuda", generator=g) * std + mean).to(dtype), layout)


def _check_sums(name, got, want, magnitude, what):
    """Each channel sum within RTOL_SUM of the sum of its terms' magnitudes.
    Returns the largest absolute error and the largest error over that sum."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w, m, label in zip(got, want, magnitude, ("first", "second")):
        err = (g.double() - w.double()).abs()
        bound = RTOL_SUM * m.double() + 1e-6
        if bool((err > bound).any()) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} disagrees with its plain version ({label} sum, {what}): "
                                 f"max err {err.max().item()}")
        worst_abs = max(worst_abs, err.max().item())
        worst_rel = max(worst_rel, (err / m.double().clamp_min(1e-30)).max().item())
    return worst_abs, worst_rel


def same_bits(fn) -> bool:
    """Two calls of ``fn`` give the same bits in every output."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(first, second))


def device_kernels(fn, tries=3):
    """Names of the device kernels that one call of ``fn`` runs, from
    torch.profiler. A call beforehand loads the library and allocates the
    cached counters. Inside the profile the call sits between two marker
    kernels (a one-element add), which must be the first and the last
    device events: the names returned are those between them. A profile
    that holds no marker lost the device's events (seen once on an H100,
    in a process's first profile: no device event at all) and is taken
    again, ``tries`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            marker.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            marker.add_(1)
            torch.cuda.synchronize()
        ran = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
        names = [e.name for e in ran]
        if len(names) >= 2 and "elementwise" in names[0] and "elementwise" in names[-1]:
            return names[1:-1]
        if names:
            break
    raise AssertionError(f"the profile does not hold both marker kernels: {names}")


def check_repeat(what, fns):
    """Each of ``fns`` (label -> call) gives the same bits twice."""
    for label, fn in fns.items():
        if not same_bits(fn):
            raise AssertionError(f"{what} {label}: two calls on the same input differ")
    return sorted(fns)


def check_one_launch(what, fns):
    """Each of ``fns`` (label -> call) runs exactly one device kernel.
    Returns the kernel names by label."""
    names = {}
    for label, fn in fns.items():
        ran = device_kernels(fn)
        if len(ran) != 1:
            raise AssertionError(f"{what} {label}: one call ran {len(ran)} device kernels: {ran}")
        names[label] = ran[0][:120]
    return names


def time_shapes(card, keys, make, time_kernel, time_plain, time_library, bytes_of, ops_of, flush):
    """Each distinct call (shape, form) of ``keys`` timed once, cold in L2
    (medians of 20): ``{(shape, form): row}``. ``make(shape, form)`` gives
    the inputs of ``time_*(inputs, form)``. ``time_library`` returns None,
    a call, or ``{name: call}`` of several PyTorch calls: then each is timed
    (``library_ms_by_call``) and ``library_ms`` is the first's."""
    rows = {}
    for shape, form in sorted(keys):
        inputs = make(shape, form)
        n, c = int(np.prod(shape)), shape[1]
        lib = time_library(inputs, form)
        calls = lib if isinstance(lib, dict) else ({} if lib is None else {"library": lib})
        by_call = {name: cuda_ms(fn, flush=flush) for name, fn in calls.items()}
        row = dict(shape=list(shape), form=form, **timing_entry(
            bytes_of(n, c, form), ops_of(n, form), card,
            ms=cuda_ms(lambda: time_kernel(inputs, form), flush=flush),
            plain_ms=cuda_ms(lambda: time_plain(inputs, form), flush=flush),
            library_ms=next(iter(by_call.values()), None)))
        if isinstance(lib, dict):
            row["library_ms_by_call"] = by_call
        rows[(shape, form)] = row
        del inputs
    return rows


def step_sum(timed, calls):
    """A model of one kernel's time over the calls of one training step, not
    a measurement in the step (that is ``profile_train``'s). ``calls``:
    Counter of (shape, form) -> calls per step, from hooks on the layers;
    ``timed``: :func:`time_shapes`' rows. Each distinct call's cold time is
    multiplied by its calls per step. Returns the sums and the per-shape
    rows."""
    rows = [dict(timed[key], calls=count) for key, count in sorted(calls.items())]
    total = dict(calls_modelled=sum(r["calls"] for r in rows))
    for key, name in (("ms", "ms_modelled_cold"), ("plain_ms", "plain_ms_modelled_cold"),
                      ("bound_ms", "bound_ms_modelled"), ("bytes", "bytes_modelled")):
        total[name] = sum(r["calls"] * r[key] for r in rows)
    by_call = {}
    for r in rows:
        for name, ms in r.get("library_ms_by_call", {}).items():
            sums = by_call.setdefault(name, dict(calls=0, library_ms_modelled_cold=0.0,
                                                 ms_modelled_cold=0.0))
            sums["calls"] += r["calls"]
            sums["library_ms_modelled_cold"] += r["calls"] * ms
            sums["ms_modelled_cold"] += r["calls"] * r["ms"]
    if by_call:
        total["library_by_call_modelled_cold"] = by_call
    with_lib = [r for r in rows if r["library_ms"] is not None]
    if with_lib:
        total["library_ms_modelled_cold"] = sum(r["calls"] * r["library_ms"] for r in with_lib)
        total["library_calls_modelled"] = sum(r["calls"] for r in with_lib)
        total["ms_modelled_cold_of_library_calls"] = sum(r["calls"] * r["ms"] for r in with_lib)
    else:
        total["library_ms_modelled_cold"] = None
    return total, rows


def _b1_case(a, b):
    got = kernels.channel_sums_cuda(a, b)
    want = channel_sums_plain(a, b)
    magnitude = channel_sums_plain(a.abs(), None if b is None else b.abs())
    torch.cuda.synchronize()
    return _check_sums("channel_sums", got, want, magnitude,
                       f"{a.dtype} {tuple(a.shape)} {a.stride()} pair={b is not None}")


def _unique(norm_shapes, kinds):
    """The distinct input shapes of the layers of ``kinds`` ("bn", "abn")
    over every model's step."""
    return sorted({s for shapes in norm_shapes.values() for k in kinds for s in shapes[k]})


def _largest(shapes):
    return max(shapes, key=lambda s: int(np.prod(s)))


def _model_of(norm_shapes, kinds, shape):
    """The first model whose layers of ``kinds`` take ``shape``."""
    return next(m for m, shapes in norm_shapes.items() if any(shape in shapes[k] for k in kinds))


def by_model_largest(norm_shapes, kinds, timing):
    """``timing(shape)`` at each model's largest input of its ``kinds``
    layers, once per distinct shape: ``{model: row}`` for the models that
    have such layers."""
    rows, out = {}, {}
    for model, shapes in norm_shapes.items():
        mine = [s for k in kinds for s in shapes[k]]
        if mine:
            big = _largest(mine)
            if big not in rows:
                rows[big] = timing(big)
            out[model] = rows[big]
    return out


BN_STATS_EPS = 1e-5


def b1_library_calls(a, b, form):
    """The one-call PyTorch counterparts of B1, checked against B1's sums by
    B1's own gate first: for the pair form ``(sum a, sum a*b)``,
    ``torch.batch_norm_backward_reduce(a, b, mean 0, invstd 1)`` (the
    reduction torch's SyncBatchNorm backward runs: its ``sum_dy`` and
    ``sum_dy_xmu``); for the single form ``torch.var_mean`` and
    ``torch.batch_norm_stats`` (BatchNorm's own statistics kernel, whose
    mean and invstd give the sums back). ``{name: call}``."""
    c = a.shape[1]
    want = kernels.channel_sums_cuda(a, b)
    magnitude = channel_sums_plain(a.abs(), None if b is None else b.abs())
    what = f"{a.dtype} {tuple(a.shape)}"
    if form == "pair":
        zero = torch.zeros(c, device=a.device)
        one = torch.ones(c, device=a.device)
        reduce = lambda: torch.batch_norm_backward_reduce(a, b, zero, one, None, True, False, False)
        _check_sums("batch_norm_backward_reduce", reduce()[:2], want, magnitude, what)
        return {"batch_norm_backward_reduce": reduce}
    n = a.numel() // c
    mean, invstd = torch.batch_norm_stats(a, BN_STATS_EPS)
    sums = (mean * n, n * (invstd.double().pow(-2) - BN_STATS_EPS + mean.double() ** 2))
    _check_sums("batch_norm_stats", sums, want, magnitude, what)
    return {"var_mean": lambda: torch.var_mean(a, dim=(0, 2, 3), correction=0),
            "batch_norm_stats": lambda: torch.batch_norm_stats(a, BN_STATS_EPS)}


def phase_kernel_b1(card: str, norm_shapes, fp32_shapes, zoo_shapes):
    """B1 against its plain version, then its time at the largest shapes of
    the training steps. ``norm_shapes``: model -> :func:`step_norm_shapes`
    of the bf16 steps; ``fp32_shapes``: the same of the fp32 steps (the
    nuclei A/B, the zoo's parity steps), checked in fp32 channels_last, not
    timed; ``zoo_shapes``: the zoo's bf16 steps, each checked, each model's
    largest timed, and ZOO_PER_STEP's steps modelled as ``norm_shapes``'."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    n_cases, max_err, max_rel = 0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, layout in (((3, 37, 19, 23), "channels_last"), ((3, 37, 19, 23), "nchw"),
                              ((1500, 48), "nchw"), ((1499, 37), "nchw"),
                              ((4, 64, 32, 32), "channels_last"), ((4, 64, 32, 32), "nchw"),
                              ((2, 24, 17, 9), "unaligned")):
            for pair in (False, True):
                a = cuda_input(shape, dtype, layout, g)
                b = cuda_input(shape, dtype, layout, g, mean=-0.2, std=1.0) if pair else None
                err, rel = _b1_case(a, b)
                max_err, max_rel, n_cases = max(max_err, err), max(max_rel, rel), n_cases + 1
    unique = _unique(norm_shapes, ("bn", "abn"))
    zoo_unique = sorted(set(_unique(zoo_shapes, ("bn",))) - set(unique))
    for shape in unique + zoo_unique:
        for pair in (False, True):
            a = cuda_input(shape, torch.bfloat16, "channels_last", g)
            b = cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0) if pair else None
            err, rel = _b1_case(a, b)
            max_err, max_rel, n_cases = max(max_err, err), max(max_rel, rel), n_cases + 1
            del a, b
    fp32_unique, fp32_err = _unique(fp32_shapes, ("bn", "abn")), 0.0
    for shape in fp32_unique:
        for pair in (False, True):
            a = cuda_input(shape, torch.float32, "channels_last", g)
            b = cuda_input(shape, torch.float32, "channels_last", g, 0.0, 1.0) if pair else None
            err, rel = _b1_case(a, b)
            fp32_err, max_rel, n_cases = max(fp32_err, err), max(max_rel, rel), n_cases + 1
    max_err = max(max_err, fp32_err)

    def largest_timing(shape):
        a = cuda_input(shape, torch.bfloat16, "channels_last", g)
        b = cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0)
        n, c = a.numel(), shape[1]
        single_lib = b1_library_calls(a, None, "single")
        pair_lib = b1_library_calls(a, b, "pair")
        single = timing_entry(
            n * 2 + 2 * 4 * c, 3 * n, card,
            ms=cuda_ms(lambda: kernels.channel_sums_cuda(a)),
            plain_ms=cuda_ms(lambda: channel_sums_plain(a)),
            library_ms=cuda_ms(single_lib["var_mean"]))
        single["library_ms_batch_norm_stats"] = cuda_ms(single_lib["batch_norm_stats"])
        return dict(shape=list(shape), dtype="bfloat16", layout="channels_last", single=single,
                    pair=timing_entry(
            2 * n * 2 + 2 * 4 * c, 3 * n, card,
            ms=cuda_ms(lambda: kernels.channel_sums_cuda(a, b)),
            plain_ms=cuda_ms(lambda: channel_sums_plain(a, b)),
            library_ms=cuda_ms(pair_lib["batch_norm_backward_reduce"])))

    big, small = _largest(unique), min(unique, key=lambda s: int(np.prod(s)))
    largest_by_model = by_model_largest(norm_shapes, ("bn", "abn"), largest_timing)
    zoo_largest_by_model = by_model_largest(zoo_shapes, ("bn",), largest_timing)
    largest = largest_by_model[_model_of(norm_shapes, ("bn", "abn"), big)]
    a = cuda_input(big, torch.bfloat16, "channels_last", g)
    b = cuda_input(big, torch.bfloat16, "channels_last", g, 0.0, 1.0)
    sa = cuda_input(small, torch.bfloat16, "channels_last", g)
    sb = cuda_input(small, torch.bfloat16, "channels_last", g, 0.0, 1.0)
    repeat = check_repeat("channel_sums", {
        "largest single": lambda: kernels.channel_sums_cuda(a),
        "largest pair": lambda: kernels.channel_sums_cuda(a, b),
        "smallest single": lambda: kernels.channel_sums_cuda(sa),
        "smallest pair": lambda: kernels.channel_sums_cuda(sa, sb)})
    del a, b, sa, sb

    calls = {}
    modelled = dict(norm_shapes, **{m: zoo_shapes[m] for m in ZOO_PER_STEP})
    for model, shapes in modelled.items():
        calls[model] = Counter()
        for shape in shapes["bn"]:
            calls[model][(shape, "single")] += 1  # forward statistics
            calls[model][(shape, "pair")] += 1    # backward (sum g, sum g*x)
        for shape in shapes["abn"]:
            calls[model][(shape, "single")] += 1
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def make(shape, form):
        x = cuda_input(shape, torch.bfloat16, "channels_last", g)
        return x, (cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0)
                   if form == "pair" else None)

    timed = time_shapes(
        card, set().union(*calls.values()), make,
        lambda xy, form: kernels.channel_sums_cuda(*xy),
        lambda xy, form: channel_sums_plain(*xy),
        lambda xy, form: b1_library_calls(*xy, form),
        lambda n, c, form: (2 if form == "pair" else 1) * n * 2 + 2 * 4 * c,
        lambda n, form: 3 * n, flush)
    del flush
    per_step, per_shape = {}, {}
    for model, model_calls in calls.items():
        per_step[model], per_shape[model] = step_sum(timed, model_calls)
        if per_step[model]["calls_modelled"] != MODEL_STEP_LAUNCHES[model]["channel_sums"]:
            raise AssertionError(f"kernel_b1: {per_step[model]['calls_modelled']} calls per "
                                 f"{model} step, expected "
                                 f"{MODEL_STEP_LAUNCHES[model]['channel_sums']}")
    beats = {"x".join(map(str, r["shape"])): r["ms"] < r["library_ms"]
             for r in timed.values() if r["form"] == "single"}
    # reported, not gated: B1 against each one-call counterpart, per shape
    # (kernel ms over library ms) and per modelled step
    versus_library = {
        name: dict(per_shape={f"{'x'.join(map(str, r['shape']))} {r['form']}":
                              r["ms"] / r["library_ms_by_call"][name]
                              for r in timed.values() if name in r["library_ms_by_call"]},
                   per_step={m: s["library_by_call_modelled_cold"][name]
                             for m, s in per_step.items()
                             if name in s.get("library_by_call_modelled_cold", {})})
        for name in ("batch_norm_backward_reduce", "var_mean", "batch_norm_stats")}
    for entry in versus_library.values():
        entry["slower_shapes"] = {k: v for k, v in entry["per_shape"].items() if v >= 1.0}
        entry["slower_steps"] = {m: s["ms_modelled_cold"] / s["library_ms_modelled_cold"]
                                 for m, s in entry["per_step"].items()
                                 if s["ms_modelled_cold"] >= s["library_ms_modelled_cold"]}
    # the calls whose plan reads one element per load (C not a multiple of 8)
    sms = kernels.sm_count(torch.device("cuda"))
    scalar = [dict(r, calls_per_step=calls["tiramisu57"][key]) for key, r in sorted(timed.items())
              if key in calls["tiramisu57"]
              and kernels.reduce_plan(key[0], torch.bfloat16, 1, True, sms, key[1] == "pair").vec == 1]
    if not scalar:
        raise AssertionError("kernel_b1: no tiramisu57 call takes the scalar (vec 1) plan")
    scalar_path = dict(model="tiramisu57", calls_per_step=sum(r["calls_per_step"] for r in scalar),
                       ms_modelled_cold=sum(r["calls_per_step"] * r["ms"] for r in scalar),
                       bound_ms_modelled=sum(r["calls_per_step"] * r["bound_ms"] for r in scalar),
                       per_shape=scalar)
    emit("kernel_b1", cases=n_cases, step_shapes=len(unique), zoo_step_shapes=len(zoo_unique),
         fp32_step_shapes=len(fp32_unique), fp32_step_max_abs_err=fp32_err, max_abs_err=max_err,
         max_err_over_sum_abs=max_rel,
         tolerance=f"per channel |err| <= {RTOL_SUM} * sum|term| + 1e-6",
         largest=largest, largest_by_model=largest_by_model,
         zoo_largest_by_model=zoo_largest_by_model, scalar_loads=scalar_path,
         per_step=per_step, per_shape=per_shape, beats_var_mean_single=beats,
         versus_library=versus_library,
         repeat_bit_identical=repeat,
         timing="device time (a spin kernel ahead of each run); largest: warm medians of "
                "20; per_shape: medians of 20 with L2 flushed before each run; per_step: "
                "each per_shape time times its calls per step",
         library="single form: torch.var_mean(x, dim=(0, 2, 3), correction=0) (library_ms) "
                 "and torch.batch_norm_stats(x, 1e-5); pair form: "
                 "torch.batch_norm_backward_reduce(g, x, mean 0, invstd 1, None, True, False, "
                 "False); each checked against B1's sums by B1's gate before it is timed")
    return dict(largest["single"], shape=list(big), pair=largest["pair"],
                largest_by_model=largest_by_model, zoo_largest_by_model=zoo_largest_by_model,
                scalar_loads=scalar_path, per_step=per_step), max_err


def _b3_case(z, g, gamma, beta, act):
    got = kernels.abn_bwd_sums_cuda(z, g, gamma, beta, act, SLOPE)
    want = abn_bwd_sums_plain(z, g, gamma, beta, act, SLOPE)
    zf, gf = z.float(), g.float()
    view = (1, z.shape[1]) + (1,) * (z.dim() - 2)
    dy = (gf * abn_ops.act_grad_from_output(zf, act, SLOPE)).abs()
    xhat = ((abn_ops.act_invert(zf, act, SLOPE) - beta.view(view)) / gamma.view(view)).abs()
    dims = (0,) + tuple(range(2, z.dim()))
    magnitude = (dy.sum(dims), (xhat * dy).sum(dims))
    torch.cuda.synchronize()
    return _check_sums("abn_bwd_sums", got, want, magnitude,
                       f"{z.dtype} {tuple(z.shape)} {z.stride()} {act}")


def _abn_output(shape, dtype, layout, act, g):
    """(z, grad, gamma, beta): z = act(y) for a seeded pre-activation y of
    both signs, so that the backward inverts real outputs."""
    c = shape[1]
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    beta = torch.randn(c, device="cuda", generator=g) * 0.3
    y = cuda_input(shape, torch.float32, "nchw", g, mean=0.0, std=1.0)
    z = in_layout(abn_ops.act_forward(y, act, SLOPE).to(dtype), layout)
    grad = torch.empty_like(z).copy_(torch.randn(shape, device="cuda", generator=g))
    return z, grad, gamma, beta


def phase_kernel_b3(card: str, norm_shapes, fp32_shapes):
    """B3 against its plain version, then its time at the largest InPlaceABN
    shapes of the bf16 training steps; the ABN shapes of the fp32 steps
    (``fp32_shapes``) checked, not timed."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    n_cases, max_err, max_rel = 0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("leaky_relu", "elu", "none"):
            for shape, layout in (((3, 37, 19, 23), "channels_last"), ((3, 37, 19, 23), "nchw"),
                                  ((1500, 48), "nchw"), ((4, 64, 32, 32), "channels_last"),
                                  ((4, 64, 32, 32), "nchw"), ((2, 24, 17, 9), "unaligned")):
                err, rel = _b3_case(*_abn_output(shape, dtype, layout, act, g), act)
                max_err, max_rel, n_cases = max(max_err, err), max(max_rel, rel), n_cases + 1
    unique = _unique(norm_shapes, ("abn",))
    for shape in unique:
        err, rel = _b3_case(*_abn_output(shape, torch.bfloat16, "channels_last", "leaky_relu", g),
                            "leaky_relu")
        max_err, max_rel, n_cases = max(max_err, err), max(max_rel, rel), n_cases + 1
    fp32_unique, fp32_err = _unique(fp32_shapes, ("abn",)), 0.0
    for shape in fp32_unique:
        err, rel = _b3_case(*_abn_output(shape, torch.float32, "channels_last", "leaky_relu", g),
                            "leaky_relu")
        fp32_err, max_rel, n_cases = max(fp32_err, err), max(max_rel, rel), n_cases + 1
    max_err = max(max_err, fp32_err)

    def b3_bytes(n, c, form):
        return 2 * n * 2 + 2 * 4 * c + 2 * 4 * c  # z, g read; gamma, beta read; two sums written

    def largest_timing(shape):
        z, grad, gamma, beta = _abn_output(shape, torch.bfloat16, "channels_last", "leaky_relu", g)
        n, c = z.numel(), shape[1]
        return dict(shape=list(shape), dtype="bfloat16", layout="channels_last",
                    activation="leaky_relu", **timing_entry(
            b3_bytes(n, c, None), 8 * n, card,
            ms=cuda_ms(lambda: kernels.abn_bwd_sums_cuda(z, grad, gamma, beta, "leaky_relu", SLOPE)),
            plain_ms=cuda_ms(lambda: abn_bwd_sums_plain(z, grad, gamma, beta, "leaky_relu", SLOPE)),
            library_ms=None))

    big, small = _largest(unique), min(unique, key=lambda s: int(np.prod(s)))
    largest = largest_timing(big)
    largest_linknet34 = largest_timing(_largest(norm_shapes["linknet34"]["abn"]))
    z, grad, gamma, beta = _abn_output(big, torch.bfloat16, "channels_last", "leaky_relu", g)
    sz, sg, sgamma, sbeta = _abn_output(small, torch.bfloat16, "channels_last", "leaky_relu", g)
    repeat = check_repeat("abn_bwd_sums", {
        "largest": lambda: kernels.abn_bwd_sums_cuda(z, grad, gamma, beta, "leaky_relu", SLOPE),
        "smallest": lambda: kernels.abn_bwd_sums_cuda(sz, sg, sgamma, sbeta, "leaky_relu", SLOPE)})
    del z, grad, sz, sg

    calls = {model: Counter((shape, "leaky_relu") for shape in shapes["abn"])
             for model, shapes in norm_shapes.items() if shapes["abn"]}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    timed = time_shapes(
        card, set().union(*calls.values()),
        lambda shape, act: _abn_output(shape, torch.bfloat16, "channels_last", act, g),
        lambda args, act: kernels.abn_bwd_sums_cuda(*args, act, SLOPE),
        lambda args, act: abn_bwd_sums_plain(*args, act, SLOPE),
        lambda args, act: None, b3_bytes, lambda n, act: 8 * n, flush)
    del flush
    per_step, per_shape = {}, {}
    for model, model_calls in calls.items():
        per_step[model], per_shape[model] = step_sum(timed, model_calls)
        if per_step[model]["calls_modelled"] != MODEL_STEP_LAUNCHES[model]["abn_bwd"]:
            raise AssertionError(f"kernel_b3: {per_step[model]['calls_modelled']} calls per "
                                 f"{model} step, expected {MODEL_STEP_LAUNCHES[model]['abn_bwd']}")
    emit("kernel_b3", cases=n_cases, step_shapes=len(unique), fp32_step_shapes=len(fp32_unique),
         fp32_step_max_abs_err=fp32_err, max_abs_err=max_err,
         max_err_over_sum_abs=max_rel,
         tolerance=f"per channel |err| <= {RTOL_SUM} * sum|term| + 1e-6",
         largest=largest, largest_linknet34=largest_linknet34,
         per_step=per_step, per_shape=per_shape, repeat_bit_identical=repeat,
         library="none: no single PyTorch call computes these sums")
    return dict(largest, largest_linknet34=largest_linknet34, per_step=per_step), max_err


# The shapes at which kernel_b2 times F.batch_norm beside B2's BatchNorm
# affine, and fails where B2 is the slower: tiramisu67's largest, ZF_UNET's
# largest and the 16x64x256^2 call.
BATCH_NORM_SHAPES = ((4, 272, 512, 512), (16, 32, 512, 512), (16, 64, 256, 256))
# The edge cases of B2's launch plan (kernels.norm_act_plan), each in fp32
# and bf16, every layout, three activations: C = 37; C = 4 mod 8 (a period
# of 2C in bf16), M not a multiple of the period's rows and a ragged element
# tail (12 and 268 channels); C = 1024; a row-major [M, C] view with both.
B2_EDGE_SHAPES = ((3, 37, 19, 23), (5, 12, 7, 9), (3, 268, 5, 7), (7, 1024, 3, 5), (1499, 37))
B2_EDGE_LAYOUTS = ("channels_last", "nchw", "unaligned", "unaligned_channels_last")
# kernel_b2's sweep over C at fixed bytes: bf16 channels_last, 285,212,672
# elements (570 MB) each, activation none.
C_SWEEP_SHAPES = ((34, 32, 512, 512), (17, 64, 512, 512), (34, 128, 256, 256),
                  (4, 272, 512, 512), (34, 512, 128, 128), (17, 1024, 128, 128))


def batch_norm_affine(x, scale, shift):
    """``x * scale + shift`` per channel as one PyTorch call, eval-mode
    ``F.batch_norm`` over mean 0 and variance 1: a call that computes B2's
    activation-none form. torch wants eps > 0; 1 + 1e-12 rounds to 1 in
    fp32, where the bf16 path computes 1/sqrt(var + eps). Returns the call,
    its constant statistics made once."""
    zeros = torch.zeros(x.shape[1], device=x.device)
    ones = torch.ones(x.shape[1], device=x.device)
    return lambda: F.batch_norm(x, zeros, ones, scale, shift, training=False, eps=1e-12)


def phase_kernel_b2(card: str, norm_shapes, fp32_shapes, zoo_shapes):
    """The kernel against its plain version, then its time at the main paths'
    shapes; the fp32 steps' calls (``fp32_shapes``) checked, not timed; the
    zoo's (``zoo_shapes``) checked, each model's largest timed beside
    F.batch_norm, ZOO_PER_STEP's steps modelled, none of them gated on
    F.batch_norm."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.float32: (0.0, 1e-6), torch.bfloat16: (8e-3, 0.0)}

    def inputs(shape, dtype, layout):
        x = cuda_input(shape, dtype, layout, g)
        c = shape[1]
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        shift = torch.randn(c, device="cuda", generator=g)
        return x, scale, shift

    n_cases, max_err = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    edge = [(s, lay) for s in B2_EDGE_SHAPES
            for lay in (B2_EDGE_LAYOUTS if len(s) == 4 else ("nchw", "unaligned"))]
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("leaky_relu", "elu", "none"):
            for shape, layout in [((1500, 48), "nchw"), ((2, 24, 17, 9), "unaligned")] + edge:
                err = _check(*inputs(shape, dtype, layout), act, tol[dtype])
                max_err[dtype] = max(max_err[dtype], err)
                n_cases += 1
    shapes = decoder_abn_shapes(BATCH, PATCH)
    # the training steps: the BatchNorm affine (no activation), InPlaceABN (leaky_relu)
    modelled = dict(norm_shapes, **{m: zoo_shapes[m] for m in ZOO_PER_STEP})
    calls = {m: Counter([(s, "none") for s in sh["bn"]] + [(s, "leaky_relu") for s in sh["abn"]])
             for m, sh in modelled.items()}
    train_cases = sorted(set().union(*calls.values()))
    zoo_cases = sorted({(s, "none") for s in _unique(zoo_shapes, ("bn",))} - set(train_cases))
    for shape, act in [(s, "leaky_relu") for s in shapes] + train_cases + zoo_cases:
        err = _check(*inputs(shape, torch.bfloat16, "channels_last"), act, tol[torch.bfloat16])
        max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
        n_cases += 1
    fp32_cases = sorted({(s, "none") for sh in fp32_shapes.values() for s in sh["bn"]}
                        | {(s, "leaky_relu") for sh in fp32_shapes.values() for s in sh["abn"]})
    for shape, act in fp32_cases:
        err = _check(*inputs(shape, torch.float32, "channels_last"), act, tol[torch.float32])
        max_err[torch.float32] = max(max_err[torch.float32], err)
        n_cases += 1
    big = max(shapes, key=lambda s: int(np.prod(s)))
    err = _check(*inputs(big, torch.float32, "nchw"), "leaky_relu", tol[torch.float32])
    max_err[torch.float32] = max(max_err[torch.float32], err)
    n_cases += 1

    bw, _, rate_src = card_rates(card)

    def timing(shape, act="leaky_relu"):
        x, scale, shift = inputs(shape, torch.bfloat16, "channels_last")
        n, c = x.numel(), shape[1]
        # x read, out written; multiply, add, select per element
        return dict(shape=list(shape), activation=act, **timing_entry(
            2 * n * x.element_size() + 2 * 4 * c, 3 * n, card,
            ms=cuda_ms(lambda: kernels.abn_norm_act_cuda(x, scale, shift, act, SLOPE)),
            plain_ms=cuda_ms(lambda: abn_norm_act_plain(x, scale, shift, act, SLOPE))))

    per_shape = [timing(s) for s in shapes]
    largest = per_shape[shapes.index(big)]
    largest_training_by_model = by_model_largest(norm_shapes, ("bn",), lambda s: timing(s, "none"))
    largest_training = largest_training_by_model[_model_of(
        norm_shapes, ("bn",), _largest([s for m in norm_shapes.values() for s in m["bn"]]))]

    def beside_batch_norm(shape):
        """B2's activation-none form and F.batch_norm at ``shape``, not gated."""
        x, scale, shift = inputs(shape, torch.bfloat16, "channels_last")
        row = timing(shape, "none")
        row["library_ms"] = cuda_ms(batch_norm_affine(x, scale, shift))
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
        return row

    zoo_largest_by_model = by_model_largest(zoo_shapes, ("bn",), beside_batch_norm)

    # B2's activation-none form, the BatchNorm affine, in one PyTorch call
    library = {}
    for shape in BATCH_NORM_SHAPES:
        x, scale, shift = inputs(shape, torch.bfloat16, "channels_last")
        affine = batch_norm_affine(x, scale, shift)
        got = affine()
        want = abn_norm_act_plain(x, scale, shift, "none", SLOPE)
        err = (got.float() - want.float()).abs()
        if (got.dtype != x.dtype or bool((err > tol[torch.bfloat16][0] * want.float().abs()).any())
                or not bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"kernel_b2: F.batch_norm {shape} {got.dtype} misses B2's bf16 "
                                 f"gate: max err {err.max().item()}")
        row = timing(shape, "none")
        row.update(library_ms=cuda_ms(affine), library_max_abs_err=err.max().item())
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
        library["x".join(map(str, shape))] = row
        del x, got, want, err
    slower = {k: r["kernel_over_library"] for k, r in library.items() if r["ms"] >= r["library_ms"]}
    if slower:
        raise AssertionError(f"kernel_b2: B2 is not faster than F.batch_norm at {slower}")

    # B2 over C at fixed bytes, beside F.batch_norm
    c_sweep = []
    for shape in C_SWEEP_SHAPES:
        x, scale, shift = inputs(shape, torch.bfloat16, "channels_last")
        err = _check(x, scale, shift, "none", tol[torch.bfloat16])
        max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
        n_cases += 1
        row = dict(shape=list(shape), **timing_entry(
            2 * x.numel() * 2 + 2 * 4 * shape[1], 3 * x.numel(), card,
            ms=cuda_ms(lambda: kernels.abn_norm_act_cuda(x, scale, shift, "none", SLOPE)),
            library_ms=cuda_ms(batch_norm_affine(x, scale, shift))))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        c_sweep.append(row)
        del x
    torch.cuda.empty_cache()

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    timed = time_shapes(
        card, set(train_cases), lambda shape, act: inputs(shape, torch.bfloat16, "channels_last"),
        lambda args, act: kernels.abn_norm_act_cuda(*args, act, SLOPE),
        lambda args, act: abn_norm_act_plain(*args, act, SLOPE),
        lambda args, act: batch_norm_affine(*args) if act == "none" else None,
        lambda n, c, act: 2 * n * 2 + 2 * 4 * c, lambda n, act: 3 * n, flush)
    del flush
    per_step, per_step_shapes = {}, {}
    for model, model_calls in calls.items():
        per_step[model], per_step_shapes[model] = step_sum(timed, model_calls)
        sums = per_step[model]
        if sums["calls_modelled"] != MODEL_STEP_LAUNCHES[model]["abn_norm_act"]:
            raise AssertionError(f"kernel_b2: {sums['calls_modelled']} calls per "
                                 f"{model} step, expected "
                                 f"{MODEL_STEP_LAUNCHES[model]['abn_norm_act']}")
        if (model not in ZOO_PER_STEP and sums["library_ms_modelled_cold"] is not None
                and sums["ms_modelled_cold_of_library_calls"] >= sums["library_ms_modelled_cold"]):
            raise AssertionError(f"kernel_b2: over {model}'s activation-none calls per step B2 "
                                 f"takes {sums['ms_modelled_cold_of_library_calls']} ms, "
                                 f"F.batch_norm {sums['library_ms_modelled_cold']}")
    zoo_slower = {m: r["kernel_over_library"] for m, r in zoo_largest_by_model.items()
                  if r["ms"] >= r["library_ms"]}
    zoo_slower.update({f"{m} {'x'.join(map(str, r['shape']))}": r["ms"] / r["library_ms"]
                       for m in ZOO_PER_STEP for r in per_step_shapes[m]
                       if r["library_ms"] is not None and r["ms"] >= r["library_ms"]})
    emit("kernel_b2", cases=n_cases, max_abs_err_fp32=max_err[torch.float32],
         max_abs_err_bf16=max_err[torch.bfloat16], tolerance={"fp32": "atol 1e-6",
                                                               "bf16": "rtol 8e-3 (one bf16 ulp)"},
         rate_source=rate_src, hbm_bytes_per_s=bw, largest=largest,
         largest_training=largest_training, largest_training_by_model=largest_training_by_model,
         training_shapes=len(train_cases), zoo_training_shapes=len(zoo_cases),
         fp32_training_cases=len(fp32_cases), per_step=per_step, per_step_shapes=per_step_shapes,
         zoo_largest_by_model=zoo_largest_by_model,
         zoo_not_faster_than_batch_norm=dict(
             by_shape=zoo_slower, note="reported, not gated: the zoo's largest shapes and "
                                       "the per-step shapes of " + ", ".join(ZOO_PER_STEP)),
         batch_norm_affine=dict(call="F.batch_norm(x, 0, 1, scale, shift, training=False, "
                                     "eps=1e-12)", tolerance="rtol 8e-3 (one bf16 ulp)",
                                by_shape=library, b2_faster_everywhere=True),
         c_sweep=c_sweep,
         per_forward=dict(launches=len(shapes), ms=sum(t["ms"] for t in per_shape),
                          plain_ms=sum(t["plain_ms"] for t in per_shape),
                          bound_ms=sum(t["bound_ms"] for t in per_shape),
                          bytes=sum(t["bytes"] for t in per_shape)),
         per_shape=per_shape)
    return (dict(largest, largest_training=largest_training,
                 largest_training_by_model=largest_training_by_model,
                 zoo_largest_by_model=zoo_largest_by_model, per_step=per_step,
                 batch_norm_affine=library, c_sweep=c_sweep),
            max(max_err.values()))


def seeded_model(device, state_dict=None, name="linknet34"):
    model = get_model(name, patch_size=PATCH, device=device, seed=SEED)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


def phase_model_parity(tmpdir: Path):
    """Seeded LinkNet34, calibrated on the CPU, through save/load_snapshot;
    one fp32 forward on the card (TF32 off) against the CPU."""
    rng = np.random.default_rng(SEED)
    cpu_model = seeded_model("cpu")
    calibrate_norms(cpu_model, torch.from_numpy(rng.standard_normal((2, 3, 128, 128), np.float32) * 0.5))
    path = tmpdir / "linknet34_snapshot.pth"
    save_snapshot(str(path), cpu_model, epoch=0, loss=0.0, train_history={}, args="chip_smoke")
    state_dict, meta = load_snapshot(str(path))
    cpu_model.load_state_dict(state_dict)
    gpu_model = seeded_model("cuda", state_dict)

    x = torch.from_numpy(rng.standard_normal((2, 3, PATCH, PATCH), np.float32) * 0.5)
    with fp32_convolutions(), torch.inference_mode():
        kernels.reset_launch_counts()
        got = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last)).cpu()
        launches = kernels.launch_counts()
        want = cpu_model(x)
    logit_err = (got - want).abs().max().item()
    prob_err = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
    ok = got.shape == (2, 1, PATCH, PATCH) and bool(torch.isfinite(got).all()) and prob_err <= 1e-3
    emit("model_parity", shape=list(got.shape), max_abs_err_logits=logit_err,
         max_abs_err_probs=prob_err, tolerance="probs atol 1e-3", logit_std=want.std().item(),
         abn_launches=launches["abn_norm_act"], snapshot_meta_epoch=meta["epoch"], ok=ok)
    if not ok or launches["abn_norm_act"] != 12:
        raise AssertionError("model_parity failed")
    return state_dict


def phase_serve(state_dict):
    model = seeded_model("cuda", state_dict)
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    rng = np.random.default_rng(SEED + 1)
    images = [rng.integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3), dtype=np.uint8)
              for _ in range(N_IMAGES + 1)]
    bf16_fn = make_predict_step(model, bf16=True)
    kw = dict(test_transform=transform, patch_size=PATCH, batch_size=BATCH, tta=True,
              weight="pyramid", device="cuda")

    t0 = time.perf_counter()
    predict_tiled(images[-1], bf16_fn, threshold=0.5, **kw)
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    masks = list(predict_tiled_stream([(i, (lambda im=im: im)) for i, im in enumerate(images[:N_IMAGES])],
                                      bf16_fn, threshold=0.5, depth=DEPTH, **kw))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_tiles = 19 * 19
    chunk = BATCH // 8
    passes = -(-n_tiles // chunk)
    for key, mask in masks:
        if mask.shape != (IMAGE_SIDE, IMAGE_SIDE) or mask.dtype != np.uint8 \
                or not set(np.unique(mask).tolist()) <= {0, 255}:
            raise AssertionError(f"serve: bad mask {key}: {mask.shape} {mask.dtype}")
    if [k for k, _ in masks] != list(range(N_IMAGES)):
        raise AssertionError("serve: masks out of order")
    expect = N_IMAGES * passes * 12
    if launches["abn_norm_act"] != expect:
        raise AssertionError(f"serve: {launches['abn_norm_act']} B2 launches, expected {expect}")

    # one model pass (64 x 3 x 512 x 512, bf16) on its own, for the share of the kernel
    x = torch.randn(BATCH, 3, PATCH, PATCH, device="cuda").contiguous(memory_format=torch.channels_last)
    pass_ms = cuda_ms(lambda: bf16_fn(x), reps=10)

    # bf16 vs fp32 (TF32 off) on a 1024^2 crop
    crop = images[0][:1024, :1024]
    with fp32_convolutions():
        p32 = predict_tiled(crop, make_predict_step(model, bf16=False), **kw)
    p16 = predict_tiled(crop, bf16_fn, **kw)
    agree = float(((p32 > 0.5) == (p16 > 0.5)).mean())
    prob_diff = float(np.abs(p32 - p16).max())

    # the tiled path on the card vs the CPU, fp32, at a small size
    small = rng.integers(0, 256, (150, 130, 3), dtype=np.uint8)
    cpu_model = seeded_model("cpu", state_dict)
    small_kw = dict(kw, patch_size=64, batch_size=16)
    with fp32_convolutions():
        small_gpu = predict_tiled(small, make_predict_step(model), **small_kw)
    small_cpu = predict_tiled(small, make_predict_step(cpu_model), **dict(small_kw, device="cpu"))
    small_err = float(np.abs(small_gpu - small_cpu).max())

    ok = agree >= 0.99 and small_err <= 1e-4 and np.isfinite(p16).all()
    emit("serve", s_per_image=seconds / N_IMAGES, seconds=seconds, images=N_IMAGES,
         image=[IMAGE_SIDE, IMAGE_SIDE, 3], patch=PATCH, batch=BATCH, tta=8, depth=DEPTH,
         dtype="bfloat16", tiles_per_image=n_tiles, model_passes_per_image=passes,
         abn_launches=launches["abn_norm_act"], abn_launches_per_image=launches["abn_norm_act"] // N_IMAGES,
         max_memory_allocated=peak, warm_image_s=warm_s, model_pass_ms=pass_ms,
         mask_positive_share=float(np.mean([m.mean() / 255 for _, m in masks])),
         bf16_vs_fp32_mask_agreement=agree, bf16_vs_fp32_max_prob_diff=prob_diff,
         small_card_vs_cpu_max_prob_err=small_err, small_tolerance="atol 1e-4", ok=bool(ok))
    if not ok:
        raise AssertionError("serve checks failed")
    return launches, seconds / N_IMAGES


# train_parity tolerances. The step is ill-conditioned at random init: a few
# gradient tensors are small differences of large terms, so one fp32 rounding
# moves them by percents. Against a float64 run of the same code, the CPU's
# own fp32 step is off by up to 2.2e-2 of a tensor's max |g| (median 5.9e-5),
# and the card's by up to 1.3e-2 (median 1.0e-3, most of it from cuDNN's fp32
# convolution algorithms: the phase also reports a card run with cuDNN off).
# A wrong formula in a normalisation layer moves every gradient upstream of
# it by order one.
# Gradient errors are relative to max(max |g| of the tensor, 1e-3 * the
# model's max |g|): a conv bias that feeds a BatchNorm has a true gradient of 0.
# The updated parameters are held to what the gradient gates allow: the
# largest move of the optimizer's step that a gradient error within
# grad_max of that scale can cause (SGD: lr * grad_max * scale), plus
# params_atol for rounding.
PARITY_TOL = {"loss_rtol": 1e-5, "grad_median": 5e-3, "grad_max": 0.1, "grad_floor": 1e-3,
              "stats_atol": 1e-5, "stats_rtol": 1e-4, "params_atol": 1e-7}
PARITY_LR = 0.01
ADAM_EPS = 1e-8


def _grad_errors(got, want):
    """Per-tensor max |got - want| over max(max |want|, floor), worst first."""
    floor = PARITY_TOL["grad_floor"] * max(float(w.abs().max()) for w in want.values())
    return sorted(((float((got[n].double() - w).abs().max()) / max(float(w.abs().max()), floor), n)
                   for n, w in want.items()), reverse=True)


def _grad_summary(errs):
    return dict(median=errs[len(errs) // 2][0], max=errs[0][0],
                worst=[dict(name=n, err=e) for e, n in errs[:3]])


def parity_runs(name, loss_name, x, y, variants, optimizer="sgd", freeze_encoder=False,
                attrs=None):
    """One ``optimizer`` step of the seeded ``name`` model, dropout off, per
    variant ``(key, device, dtype)`` (key ``card_no_cudnn`` turns cuDNN off,
    ``cpu_channels_last`` runs the CPU in channels_last memory, a key
    ending in ``_normal`` leaves ``attrs`` unset;
    ``freeze_encoder``: the encoder's gradients zeroed; ``attrs`` set on the
    model, e.g. ``s2d=True``):
    ``{key: (loss, gradients, state, launches)}``, launches on the card."""
    runs = {}
    with fp32_convolutions():
        for key, device, dtype in variants:
            torch.backends.cudnn.enabled = key != "card_no_cudnn"
            model = no_dropout(seeded_model(device, name=name).to(dtype))
            for attr, value in ({} if key.endswith("_normal") else attrs or {}).items():
                setattr(model, attr, value)
            xb = x.to(device, dtype)
            if key == "cpu_channels_last":
                model = model.to(memory_format=torch.channels_last)
                xb = xb.contiguous(memory_format=torch.channels_last)
            trainable = (without_encoder(name, (n for n, _ in model.named_parameters()))
                         if freeze_encoder else None)
            step = make_train_step(model, get_optimizer(optimizer, model.parameters(), PARITY_LR),
                                   get_loss(loss_name), default_metrics(),
                                   trainable_mask=trainable)
            kernels.reset_launch_counts()
            logs = step(xb, y.to(device, dtype), PARITY_LR)
            launches = None
            if device == "cuda":
                torch.cuda.synchronize()
                launches = kernels.launch_counts()
            runs[key] = (float(logs["loss"]),
                         {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                         {k: v.detach().cpu() for k, v in model.state_dict().items()}, launches)
    return runs


def update_bound(optimizer, g, delta):
    """Per element, the largest move of one first step of ``optimizer`` (lr
    PARITY_LR) that a gradient error of up to ``delta`` from ``g`` can
    cause. SGD moves by lr * g, so lr * delta. Adam's first step moves by
    lr * g / (|g| + eps), increasing in g, so the larger of its changes
    from g to g + delta and from g - delta to g."""
    if optimizer == "sgd":
        return torch.full_like(g, PARITY_LR * delta)
    step = lambda t: t / (t.abs() + ADAM_EPS)
    return PARITY_LR * torch.maximum(step(g + delta) - step(g), step(g) - step(g - delta))


def parity_verdict(runs, expected_launches, optimizer="sgd", params_cap=None):
    """The card's run against the CPU's and the float64 run by PARITY_TOL:
    ``(fields, ok)``. Each updated parameter tensor is held to
    :func:`update_bound` of the CPU's gradient with delta = grad_max times the
    scale the gradient gates use, plus params_atol; and, where
    ``params_cap`` is given, every parameter also to that absolute error."""
    (loss_g, grads_g, state_g, launches), (loss_c, grads_c, state_c, _) = runs["card"], runs["cpu"]
    grads_64 = runs["cpu_f64"][1]
    t = PARITY_TOL
    floor = t["grad_floor"] * max(float(w.abs().max()) for w in grads_c.values())
    fields = dict(loss_card=loss_g, loss_cpu=loss_c, loss_cpu_f64=runs["cpu_f64"][0],
                  grad_err_card_vs_cpu=_grad_summary(_grad_errors(grads_g, grads_c)),
                  grad_err_card_vs_f64=_grad_summary(_grad_errors(grads_g, grads_64)),
                  grad_err_cpu_vs_f64=_grad_summary(_grad_errors(grads_c, grads_64)))
    if "card_no_cudnn" in runs:
        fields["grad_err_card_no_cudnn_vs_f64"] = _grad_summary(
            _grad_errors(runs["card_no_cudnn"][1], grads_64))
    stats_err, params_err, params_ratio = 0.0, 0.0, (0.0, None)
    gate_range = [float("inf"), 0.0]
    stats_ok = True
    for k, v in state_c.items():
        if k.endswith("num_batches_tracked"):
            stats_ok &= int(state_g[k]) == int(v) == 1
        elif k.endswith(("running_mean", "running_var")):
            err = (state_g[k] - v).abs()
            stats_err = max(stats_err, float(err.max()))
            stats_ok &= bool((err <= t["stats_atol"] + t["stats_rtol"] * v.abs()).all())
        else:
            g = grads_c[k]
            delta = t["grad_max"] * max(float(g.abs().max()), floor)
            gate = update_bound(optimizer, g, delta) + t["params_atol"]
            err = (state_g[k].double() - v.double()).abs()
            params_err = max(params_err, float(err.max()))
            ratio = float((err / gate).max())
            params_ratio = max(params_ratio, (ratio, k), key=lambda r: r[0])
            gate_range = [min(gate_range[0], float(gate.min())), max(gate_range[1], float(gate.max()))]
    grads_ok = all(fields[k]["median"] <= t["grad_median"] and fields[k]["max"] <= t["grad_max"]
                   for k in ("grad_err_card_vs_cpu", "grad_err_card_vs_f64"))
    ok = (abs(loss_g - loss_c) <= t["loss_rtol"] * abs(loss_c) and np.isfinite(loss_g)
          and grads_ok and stats_ok and params_ratio[0] <= 1.0 and launches == expected_launches
          and (params_cap is None or params_err <= params_cap))
    fields.update(max_running_stat_err=stats_err, max_param_err=params_err,
                  param_err_over_gate=dict(worst=params_ratio[0], name=params_ratio[1]),
                  param_gate_range=gate_range, params_cap=params_cap, optimizer=optimizer, launches=launches, expected_launches=expected_launches,
                  tolerance=t)
    return fields, bool(ok)


def phase_train_parity():
    """One SGD training step of the seeded LinkNet34 on 2x3x128x128 SHAPES
    (dropout off): fp32 on the card (TF32 off) against fp32 on the CPU, and
    both against the same step in float64 on the CPU."""
    x, y = to_nchw([ShapesDataset(2, 128, seed=SEED + 30)[i] for i in range(2)])
    runs = parity_runs("linknet34", "bce_jaccard", x, y, (
        ("card", "cuda", torch.float32), ("card_no_cudnn", "cuda", torch.float32),
        ("cpu", "cpu", torch.float32), ("cpu_f64", "cpu", torch.float64)))
    # LinkNet34's parameters have been held to 1e-6 since its step was
    # ported; the derived gate reaches 8e-5 for its largest gradients, so
    # this phase keeps both
    fields, ok = parity_verdict(runs, STEP_LAUNCHES, params_cap=1e-6)
    emit("train_parity", input=[2, 3, 128, 128], lr=PARITY_LR, **fields, ok=ok)
    if not ok:
        raise AssertionError("train_parity failed")


def eval_parity(name, side, seed):
    """The seeded full-width ``name``, its normalisations calibrated on the
    CPU on 2x3xside^2: one 1x3xside^2 fp32 eval forward on the card (TF32
    off) against the CPU, probabilities within atol 1e-3: ``(fields, ok)``."""
    rng = np.random.default_rng(seed)
    cpu_model = seeded_model("cpu", name=name)
    calibrate_norms(cpu_model, torch.from_numpy(rng.standard_normal((2, 3, side, side), np.float32) * 0.5))
    gpu_model = seeded_model("cuda", cpu_model.state_dict(), name=name)
    x = torch.from_numpy(rng.standard_normal((1, 3, side, side), np.float32) * 0.5)
    with fp32_convolutions(), torch.inference_mode():
        got = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last)).cpu()
        want = cpu_model(x)
    prob_err = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
    ok = got.shape == (1, 1, side, side) and bool(torch.isfinite(got).all()) and prob_err <= 1e-3
    return dict(forward_input=[1, 3, side, side], max_abs_err_logits=(got - want).abs().max().item(),
                max_abs_err_probs=prob_err, forward_tolerance="probs atol 1e-3",
                logit_std=want.std().item(), forward_ok=ok), ok


STEP_VARIANTS = (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                 ("cpu_f64", "cpu", torch.float64))


def phase_zf_unet_parity():
    """Full-width ZF_UNET: the eval forward at 1x3x256x256 card against CPU,
    then one SGD bce step on 2x3x128x128 SHAPES (dropout off), card against
    CPU and float64."""
    forward, forward_ok = eval_parity("zf_unet", 256, SEED + 60)
    xs, ys = to_nchw([ShapesDataset(2, 128, seed=SEED + 31)[i] for i in range(2)])
    runs = parity_runs("zf_unet", "bce", xs, ys, STEP_VARIANTS)
    fields, step_ok = parity_verdict(runs, MODEL_STEP_LAUNCHES["zf_unet"])
    emit("zf_unet_parity", **forward, step_input=[2, 3, 128, 128], lr=PARITY_LR, **fields,
         step_ok=step_ok, ok=forward_ok and step_ok)
    if not (forward_ok and step_ok):
        raise AssertionError("zf_unet_parity failed")


def phase_tiramisu_parity():
    """Full-width tiramisu67: the eval forward at 1x3x128x128 card against
    CPU, then one SGD bce step on 2x3x64x64 SHAPES (dropout off), card
    against CPU and float64, launches 120/60/0."""
    forward, forward_ok = eval_parity("tiramisu67", 128, SEED + 70)
    xs, ys = to_nchw([ShapesDataset(2, 64, seed=SEED + 32)[i] for i in range(2)])
    runs = parity_runs("tiramisu67", "bce", xs, ys, STEP_VARIANTS)
    fields, step_ok = parity_verdict(runs, MODEL_STEP_LAUNCHES["tiramisu67"])
    emit("tiramisu_parity", **forward, step_input=[2, 3, 64, 64], lr=PARITY_LR, **fields,
         step_ok=step_ok, ok=forward_ok and step_ok)
    if not (forward_ok and step_ok):
        raise AssertionError("tiramisu_parity failed")


def phase_albunet_parity():
    """Full-width AlbuNet: the eval forward at 1x3x128x128 card against CPU,
    then one Adam bce step with the encoder frozen on 2x3x64x64 SHAPES, card
    against CPU and float64, launches 72/36/0; the frozen parameters keep
    their bits on the card and every encoder running statistic moves."""
    forward, forward_ok = eval_parity("albunet", 128, SEED + 80)
    xs, ys = to_nchw([ShapesDataset(2, 64, seed=SEED + 33)[i] for i in range(2)])
    runs = parity_runs("albunet", "bce", xs, ys, STEP_VARIANTS, optimizer="adam",
                       freeze_encoder=True)
    fields, step_ok = parity_verdict(runs, MODEL_STEP_LAUNCHES["albunet"], optimizer="adam")
    initial = seeded_model("cpu", name="albunet").state_dict()
    after = runs["card"][2]
    prefixes = ENCODER_PREFIXES["albunet"]
    frozen = [n for n, _ in seeded_model("cpu", name="albunet").named_parameters()
              if n.startswith(prefixes)]
    stats = [k for k in initial if k.startswith(prefixes) and k.endswith(("mean", "var"))]
    unchanged = sum(torch.equal(after[n], initial[n]) for n in frozen)
    moved = sum(not torch.equal(after[k], initial[k]) for k in stats)
    frozen_ok = unchanged == len(frozen) == 108 and moved == len(stats) == 72
    emit("albunet_parity", **forward, step_input=[2, 3, 64, 64], lr=PARITY_LR, **fields,
         frozen_parameters=len(frozen), frozen_unchanged=unchanged, encoder_running_stats=len(stats),
         encoder_running_stats_moved=moved, step_ok=step_ok,
         ok=forward_ok and step_ok and frozen_ok)
    if not (forward_ok and step_ok and frozen_ok):
        raise AssertionError("albunet_parity failed")


def train_run(name, loss_name, optimizer, warmup, steps, remat=False, batch=TRAIN_BATCH,
              freeze_encoder=False, attrs=None):
    """``warmup`` then ``steps`` timed full-width training steps of the
    seeded ``name`` model at ``batch``, patch 512, bf16 autocast, lr 1e-3, on
    one fixed DeviceShapes batch; ``freeze_encoder``: the encoder's gradients
    zeroed; ``attrs`` set on the model (``s2d``, ``packed``, ...). The launch
    counts and the copies of BatchNorm inputs (``_dense``) are set to 0 just
    before the timed steps and read just after them."""
    model = seeded_model("cuda", name=name)
    if remat:
        model.remat = True
    for attr, value in (attrs or {}).items():
        setattr(model, attr, value)
    names = [n for n, _ in model.named_parameters()]
    trainable = without_encoder(name, names) if freeze_encoder else None
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if trainable is not None and n not in trainable}
    opt = get_optimizer(optimizer, model.parameters(), TRAIN_LR)
    step = make_train_step(model, opt, get_loss(loss_name), default_metrics(), bf16=True,
                           trainable_mask=trainable)
    x, y = DeviceShapes(PATCH, device="cuda").batch(
        batch, torch.Generator(device="cuda").manual_seed(SEED + 40))
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(x, y, TRAIN_LR)["loss"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    abn_ops._dense.copies = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = step(x, y, TRAIN_LR)
        losses.append(logs["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    tracked = sorted({int(m.num_batches_tracked) for m in model.modules()
                      if isinstance(m, BatchNormTorch)})
    losses = [float(v) for v in losses]
    params = dict(model.named_parameters())
    return dict(model=name, batch=batch, patch=PATCH, dtype="bf16 autocast", loss=loss_name,
                optimizer=optimizer, lr=TRAIN_LR, remat=remat, attrs=attrs or {},
                warmup_steps=warmup, steps=steps,
                frozen_parameters=len(frozen),
                frozen_unchanged=sum(torch.equal(p, params[n]) for n, p in frozen.items()),
                images_per_s=batch * steps / seconds, ms_per_step=seconds * 1e3 / steps,
                seconds=seconds, warm_s=warm_s, max_memory_allocated=torch.cuda.max_memory_allocated(),
                first_loss=losses[0], last_loss=losses[-1], losses=losses,
                last_logs={k: float(v) for k, v in logs.items()}, launches=launches,
                launches_per_step={k: v / steps for k, v in launches.items()},
                dense_copies=abn_ops._dense.copies, num_batches_tracked=tracked)


def _run_ok(run, expected_per_step, decreasing=True):
    """Finite losses, the last below the first (``decreasing``), launches per
    step as the layer count, no copy of a BatchNorm input."""
    return (all(np.isfinite(run["losses"])) and (run["losses"][-1] < run["losses"][0]
                                                 or not decreasing)
            and run["launches_per_step"] == {k: float(v) for k, v in expected_per_step.items()}
            and np.isfinite(run["last_logs"]["grad_absmax"]) and run["dense_copies"] == 0)


def phase_train():
    """The training path: full-width LinkNet34 training steps on the card."""
    run = train_run("linknet34", "bce_jaccard", "adam", TRAIN_WARMUP, TRAIN_STEPS)
    ok = _run_ok(run, STEP_LAUNCHES)
    emit("train", **run, expected_launches_per_step=STEP_LAUNCHES, ok=ok)
    if not ok:
        raise AssertionError("train checks failed")
    return run["launches"], run["ms_per_step"]


def phase_train_zf_unet(smi: str):
    """segtpu's default bench config, zf_unet-512, then a few steps under
    ``--remat``'s rematerialisation."""
    run = train_run("zf_unet", "bce", "sgd", TRAIN_WARMUP, TRAIN_STEPS)
    expected = MODEL_STEP_LAUNCHES["zf_unet"]
    # the upsampling stays in bf16 under autocast (whose fp32 list holds it)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        up_dtype = upsample_nearest(torch.zeros(1, 4, 2, 2, device="cuda", dtype=torch.bfloat16)).dtype
    remat = train_run("zf_unet", "bce", "sgd", 1, 2, remat=True)
    remat_ok = (all(np.isfinite(remat["losses"])) and remat["num_batches_tracked"] == [3]
                and remat["dense_copies"] == 0)
    ok = _run_ok(run, expected) and remat_ok and up_dtype == torch.bfloat16
    emit("train_zf_unet", card=smi, config="zf_unet-512", **run,
         upsample_dtype_under_autocast=str(up_dtype),
         expected_launches_per_step=expected,
         remat_run={k: remat[k] for k in ("steps", "ms_per_step", "max_memory_allocated", "losses",
                                      "launches_per_step", "num_batches_tracked",
                                      "dense_copies")},
         remat_note="launches per step under remat include the recomputed forwards; "
                    "num_batches_tracked after 3 steps must be 3", ok=bool(ok))
    if not ok:
        raise AssertionError("train_zf_unet checks failed")
    return run["launches"]


def phase_train_unet_abn(smi: str):
    """Full-width UNetABN steps (B1, B2, B3 on the UNet family), then two UNet
    steps for its launch counts."""
    run = train_run("unet_abn", "bce_jaccard", "adam", TRAIN_WARMUP, 5)
    plain = train_run("unet", "bce", "sgd", 1, 2)
    ok = (_run_ok(run, MODEL_STEP_LAUNCHES["unet_abn"])
          and _run_ok(plain, MODEL_STEP_LAUNCHES["unet"], decreasing=False))
    emit("train_unet_abn", card=smi, **run,
         expected_launches_per_step=MODEL_STEP_LAUNCHES["unet_abn"],
         unet={k: plain[k] for k in ("loss", "optimizer", "steps", "ms_per_step", "losses",
                                     "launches_per_step", "dense_copies")},
         unet_expected_launches_per_step=MODEL_STEP_LAUNCHES["unet"], ok=bool(ok))
    if not ok:
        raise AssertionError("train_unet_abn checks failed")
    launches = Counter(run["launches"])
    launches.update(plain["launches"])
    return dict(launches)


def phase_train_tiramisu67(smi: str):
    """The bench config tiramisu67-512-b4 (batch 4, patch 512, bf16, bce,
    SGD lr 1e-3): 3 warm then 10 timed steps, launches per step (120, 60,
    0), no copy of a BatchNorm input; then 1 warm and 2 timed steps under
    ``--remat``'s per-block rematerialisation."""
    run = train_run("tiramisu67", "bce", "sgd", TRAIN_WARMUP, TIRAMISU_STEPS, batch=TIRAMISU_BATCH)
    expected = MODEL_STEP_LAUNCHES["tiramisu67"]
    remat = train_run("tiramisu67", "bce", "sgd", 1, 2, remat=True, batch=TIRAMISU_BATCH)
    remat_ok = (all(np.isfinite(remat["losses"])) and remat["num_batches_tracked"] == [3]
                and remat["dense_copies"] == 0)
    ok = _run_ok(run, expected) and remat_ok
    emit("train_tiramisu67", card=smi, config="tiramisu67-512-b4", **run,
         expected_launches_per_step=expected,
         remat_run={k: remat[k] for k in ("steps", "ms_per_step", "max_memory_allocated", "losses",
                                      "launches_per_step", "num_batches_tracked",
                                      "dense_copies")},
         remat_note="launches per step under remat include the recomputed dense blocks; "
                    "num_batches_tracked after 3 steps must be 3", ok=bool(ok))
    if not ok:
        raise AssertionError("train_tiramisu67 checks failed")
    return run["launches"]


def phase_train_albunet(smi: str):
    """The bench config albunet-finetune-512 (batch 16, patch 512, bf16, bce,
    Adam lr 1e-3, encoder frozen): 3 warm then 5 timed steps, launches per
    step (72, 36, 0); the 108 encoder parameters keep their bits."""
    run = train_run("albunet", "bce", "adam", TRAIN_WARMUP, 5, freeze_encoder=True)
    expected = MODEL_STEP_LAUNCHES["albunet"]
    ok = _run_ok(run, expected) and run["frozen_unchanged"] == run["frozen_parameters"] == 108
    emit("train_albunet", card=smi, config="albunet-finetune-512", **run,
         expected_launches_per_step=expected, ok=bool(ok))
    if not ok:
        raise AssertionError("train_albunet checks failed")
    return run["launches"], run["ms_per_step"]


def phase_train_unet11(smi: str):
    """The bench config unet11-finetune-512 (batch 16, patch 512, bf16, bce,
    Adam lr 1e-3, the VGG stages frozen), in normal space: 3 warm then 5
    timed steps; TernausNet has no normalisation layer, so no kernel of this
    repo runs (launches 0, 0, 0); the 16 encoder parameters keep their bits.
    Then 1 warm and 2 timed UNet16 steps on the same recipe."""
    run = train_run("unet11", "bce", "adam", TRAIN_WARMUP, 5, freeze_encoder=True)
    u16 = train_run("unet16", "bce", "adam", 1, 2, freeze_encoder=True)
    expected = MODEL_STEP_LAUNCHES["unet11"]
    ok = (_run_ok(run, expected) and _run_ok(u16, MODEL_STEP_LAUNCHES["unet16"], decreasing=False)
          and run["frozen_unchanged"] == run["frozen_parameters"] == 16
          and u16["frozen_unchanged"] == u16["frozen_parameters"] == 26)
    emit("train_unet11", card=smi, config="unet11-finetune-512", **run,
         expected_launches_per_step=expected,
         unet16={k: u16[k] for k in ("steps", "ms_per_step", "images_per_s", "max_memory_allocated",
                                     "losses", "launches_per_step", "frozen_parameters",
                                     "frozen_unchanged")}, ok=bool(ok))
    if not ok:
        raise AssertionError("train_unet11 checks failed")
    launches = Counter(run["launches"])
    launches.update(u16["launches"])
    return dict(launches)


# The zoo's parity runs: the card, the CPU in two memory layouts (two fp32
# roundings of the same step) and the CPU in float64.
ZOO_VARIANTS = (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                ("cpu_channels_last", "cpu", torch.float32), ("cpu_f64", "cpu", torch.float64))
# A zoo gate is PARITY_TOL's, or ZOO_NOISE x the larger of the two CPU fp32
# runs' own errors against float64 where that is larger.
ZOO_NOISE = 4


def zoo_verdict(runs, expected_launches):
    """A zoo model's step, card against float64: each gate of PARITY_TOL, or
    ZOO_NOISE x the CPU fp32 steps' own error against float64 where that is
    larger (the deep models' steps are ill-conditioned at 2 x 3 x 64^2:
    PSPNet's pyramid normalises 2 rows at bin 1, and 100-155 layers of
    random init move a gradient by percents between two fp32 roundings).
    Loss, the gradients' median and max, each running statistic, and each
    updated parameter tensor to the move that a gradient error at the
    gradient gate allows; launches as the layer count. ``(fields, ok)``."""
    loss_g, grads_g, state_g, launches = runs["card"]
    loss_64, grads_64, state_64 = runs["cpu_f64"][:3]
    cpus = [runs["cpu"], runs["cpu_channels_last"]]
    t, k_noise = PARITY_TOL, ZOO_NOISE
    card_64 = _grad_errors(grads_g, grads_64)
    cpu_64 = [_grad_errors(c[1], grads_64) for c in cpus]
    gates = dict(loss=max(t["loss_rtol"] * abs(loss_64),
                          k_noise * max(abs(c[0] - loss_64) for c in cpus)),
                 grad_median=max(t["grad_median"], k_noise * max(e[len(e) // 2][0] for e in cpu_64)),
                 grad_max=max(t["grad_max"], k_noise * max(e[0][0] for e in cpu_64)))
    floor = t["grad_floor"] * max(float(g.abs().max()) for g in grads_64.values())
    worst_state, state_ok = (0.0, None), True
    for k, v in state_64.items():
        if k.endswith("num_batches_tracked"):
            state_ok &= int(state_g[k]) == 1 and all(int(c[2][k]) == 1 for c in cpus)
            continue
        v = v.double()
        err = float((state_g[k].double() - v).abs().max())
        cpu_err = max(float((c[2][k].double() - v).abs().max()) for c in cpus)
        if k.endswith(("running_mean", "running_var")):
            gate = max(t["stats_atol"] + t["stats_rtol"] * float(v.abs().max()), k_noise * cpu_err)
        else:
            # SGD's move for a gradient error at the gradient gate, as parity_verdict's
            delta = gates["grad_max"] * max(float(grads_64[k].abs().max()), floor)
            gate = PARITY_LR * delta + t["params_atol"]
        worst_state = max(worst_state, (err / gate, k), key=lambda r: r[0])
        state_ok &= err <= gate
    ok = (abs(loss_g - loss_64) <= gates["loss"] and np.isfinite(loss_g)
          and card_64[len(card_64) // 2][0] <= gates["grad_median"]
          and card_64[0][0] <= gates["grad_max"] and state_ok
          and launches == expected_launches)
    fields = dict(loss_card=loss_g, loss_cpu=[c[0] for c in cpus], loss_cpu_f64=loss_64,
                  grad_err_card_vs_f64=_grad_summary(card_64),
                  grad_err_cpu_vs_f64=[_grad_summary(e) for e in cpu_64],
                  grad_err_card_vs_cpu=_grad_summary(_grad_errors(grads_g, runs["cpu"][1])),
                  gates=gates, state_err_over_gate=dict(worst=worst_state[0], name=worst_state[1]),
                  launches=launches, expected_launches=expected_launches)
    return fields, bool(ok)


def zoo_eval_parity(name, side, seed):
    """:func:`eval_parity` held to float64: the seeded full-width ``name``,
    calibrated on the CPU on 2 x 3 x side^2, one 1 x 3 x side^2 fp32 eval
    forward on the card (TF32 off), on the CPU and on the CPU in float64.
    The card's probabilities within atol 1e-3 of float64's, or within
    ZOO_NOISE x the CPU fp32 forwards' own error (NCHW and channels_last)
    where that is larger: calibrated on two images, a random-init
    ResNet-152 has channels of near-zero running variance whose eval
    BatchNorm scales rounding by up to 1/sqrt(eps). ``(fields, ok)``."""
    rng = np.random.default_rng(seed)
    cpu_model = seeded_model("cpu", name=name)
    calibrate_norms(cpu_model, torch.from_numpy(rng.standard_normal((2, 3, side, side), np.float32) * 0.5))
    gpu_model = seeded_model("cuda", cpu_model.state_dict(), name=name)
    x = torch.from_numpy(rng.standard_normal((1, 3, side, side), np.float32) * 0.5)
    with fp32_convolutions(), torch.inference_mode():
        got = gpu_model(x.cuda().contiguous(memory_format=torch.channels_last)).cpu()
        want = cpu_model(x)
        want_cl = cpu_model.to(memory_format=torch.channels_last)(
            x.contiguous(memory_format=torch.channels_last))
        want64 = cpu_model.double()(x.double())
    prob = lambda t: torch.sigmoid(t.double())
    err = (prob(got) - prob(want64)).abs().max().item()
    cpu_err = max((prob(w) - prob(want64)).abs().max().item() for w in (want, want_cl))
    gate = max(1e-3, ZOO_NOISE * cpu_err)
    ok = got.shape == (1, 1, side, side) and bool(torch.isfinite(got).all()) and err <= gate
    return dict(forward_input=[1, 3, side, side],
                max_abs_err_logits_vs_cpu=(got - want).abs().max().item(),
                max_abs_err_probs_vs_cpu=(prob(got) - prob(want)).abs().max().item(),
                max_abs_err_probs_vs_f64=err, cpu_max_abs_err_probs_vs_f64=cpu_err,
                forward_gate=gate, logit_std=want.std().item(), forward_ok=ok), ok


def phase_zoo_parity():
    """Each zoo model at full width: the fp32 eval forward on the card (TF32
    off) at 1 x 3 x side^2 by :func:`zoo_eval_parity`, then one SGD bce step
    on 2 x 3 x 64^2 SHAPES (dropout off) on the card, the CPU and the CPU in
    float64, by :func:`zoo_verdict`; launches as the layer count; PSPNet's
    head BatchNorms at momentum 0.95."""
    xs, ys = to_nchw([ShapesDataset(2, 64, seed=SEED + 34)[i] for i in range(2)])
    results, failed = {}, []
    for i, name in enumerate(ZOO_BATCH):
        t0 = time.perf_counter()
        forward, forward_ok = zoo_eval_parity(name, ZOO_SIDE[name], SEED + 90 + i)
        runs = parity_runs(name, "bce", xs, ys, ZOO_VARIANTS)
        fields, step_ok = zoo_verdict(runs, MODEL_STEP_LAUNCHES[name])
        results[name] = dict(forward, **fields, step_ok=step_ok, seconds=time.perf_counter() - t0)
        if not (forward_ok and step_ok):
            failed.append(name)
        del runs
        torch.cuda.empty_cache()
    psp = seeded_model("cpu", name="psp_net")
    momenta = sorted({m.momentum for n, m in psp.named_modules()
                      if isinstance(m, BatchNormTorch) and n.startswith(("ppm.", "final."))})
    ok = not failed and momenta == [0.95]
    emit("zoo_parity", step_input=[2, 3, 64, 64], lr=PARITY_LR, models=results,
         psp_head_momenta=momenta, failed=failed, ok=ok)
    if not ok:
        raise AssertionError(f"zoo_parity failed: {failed}")


def _bf16_bilinear(x, out_hw, align_corners=True):
    """``upsample_bilinear`` with its output kept in its input's dtype (a
    variant timed beside the port's, not used by it)."""
    with torch.autocast(x.device.type, enabled=False):
        return layers_mod.upsample_bilinear(x, out_hw, align_corners)


def phase_train_zoo(smi: str):
    """Each zoo model at patch 512, bf16 autocast, bce, SGD lr 1e-3, on one
    fixed DeviceShapes batch (ZOO_BATCH): 3 warm then ZOO_STEPS timed steps,
    launches per step as the layer count, finite losses, no copy of a
    BatchNorm input; whether the last loss is below the first is reported
    per model (``loss_fell``), and a model whose loss did not fall is
    listed, not failed. Then GCN's and PSPNet's steps again with the
    bilinear upsampling kept in bf16, 1 warm and 3 timed."""
    runs, launches, failed = {}, Counter(), []
    for name, batch in ZOO_BATCH.items():
        run = train_run(name, "bce", "sgd", TRAIN_WARMUP, ZOO_STEPS, batch=batch)
        run["ok"] = _run_ok(run, MODEL_STEP_LAUNCHES[name], decreasing=False)
        run["loss_fell"] = run["losses"][-1] < run["losses"][0]
        if not run["ok"]:
            failed.append(name)
        launches.update(run["launches"])
        runs[name] = {k: run[k] for k in ("batch", "steps", "images_per_s", "ms_per_step",
                                          "warm_s", "max_memory_allocated", "first_loss",
                                          "last_loss", "losses", "loss_fell",
                                          "launches_per_step", "dense_copies", "ok")}
        torch.cuda.empty_cache()
    bilinear = {}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        up = layers_mod.upsample_bilinear(torch.zeros(1, 4, 2, 2, device="cuda",
                                                      dtype=torch.bfloat16), (4, 4))
    for name, module_name in ZOO_BILINEAR.items():
        module = importlib.import_module(module_name)
        saved = module.upsample_bilinear
        module.upsample_bilinear = _bf16_bilinear
        try:
            run = train_run(name, "bce", "sgd", 1, 3, batch=ZOO_BATCH[name])
        finally:
            module.upsample_bilinear = saved
        bilinear[name] = dict(ms_per_step_bf16_upsampling=run["ms_per_step"],
                              ms_per_step_fp32_upsampling=runs[name]["ms_per_step"],
                              max_memory_allocated_bf16_upsampling=run["max_memory_allocated"],
                              losses=run["losses"])
        torch.cuda.empty_cache()
    ok = not failed
    emit("train_zoo", card=smi, patch=PATCH, dtype="bf16 autocast", loss="bce", optimizer="sgd",
         lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, models=runs,
         expected_launches_per_step={m: MODEL_STEP_LAUNCHES[m] for m in ZOO_BATCH},
         upsample_bilinear_dtype_under_autocast=str(up.dtype), bilinear_in_bf16=bilinear,
         loss_not_falling=[m for m, r in runs.items() if not r["loss_fell"]], failed=failed,
         ok=ok)
    if not ok:
        raise AssertionError(f"train_zoo failed: {failed}")
    return dict(launches)


def phase_serve_zoo(smi: str):
    """The submit CLI's path (``predict_tiled_stream``) with DilatedLinkNet34
    over one seeded 5000 x 5000 image after a warm 1024 x 1024 one: patch
    512, tile batch 64, D4 TTA, bf16. Eval-mode BatchNorm is F.batch_norm
    over the running statistics: no kernel of this repo runs."""
    model = seeded_model("cuda", name="dilated_linknet34")
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    rng = np.random.default_rng(SEED + 2)
    image = rng.integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3), dtype=np.uint8)
    fn = make_predict_step(model, bf16=True)
    kw = dict(test_transform=transform, patch_size=PATCH, batch_size=BATCH, tta=True,
              weight="pyramid", device="cuda")
    predict_tiled(image[:1024, :1024], fn, threshold=0.5, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (key, mask), = list(predict_tiled_stream([(0, lambda: image)], fn, threshold=0.5,
                                             depth=DEPTH, **kw))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ok = (mask.shape == (IMAGE_SIDE, IMAGE_SIDE) and mask.dtype == np.uint8
          and set(np.unique(mask).tolist()) <= {0, 255} and launches == NO_LAUNCHES)
    emit("serve_zoo", card=smi, model="dilated_linknet34", s_per_image=seconds,
         image=[IMAGE_SIDE, IMAGE_SIDE, 3], patch=PATCH, batch=BATCH, tta=8, dtype="bfloat16",
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         mask_positive_share=float(mask.mean() / 255), ok=bool(ok))
    if not ok:
        raise AssertionError("serve_zoo checks failed")
    return launches


def phase_train_cli_psp_net(tmpdir: Path):
    """The train CLI on ``-m psp_net -d shapes-device -s 2 -e 1 --bf16`` at
    batch 8, patch 512, bce, SGD: launches 2 x (218, 109, 0), and none in
    the validation batch (eval-mode BatchNorm)."""
    exp = tmpdir / "psp_net"
    argv = ["-m", "psp_net", "-l", "bce", "-o", "sgd", "-lr", "1e-3", "-b",
            str(ZOO_BATCH["psp_net"]), "-p", str(PATCH), "--bf16", "--no-tensorboard", "--seed",
            "0", "-d", "shapes-device", "-s", "2", "-e", "1", "--experiments-dir", str(exp)]
    history, out = cli_run("psp_net", argv, 2, 1, None,
                           step_launches=MODEL_STEP_LAUNCHES["psp_net"],
                           eval_launches=NO_LAUNCHES, batch=ZOO_BATCH["psp_net"])
    files = sorted(p.name for p in exp.rglob("*.pth"))
    ok = history["epoch"] == [0] and files == ["psp_net_checkpoint.pth", "psp_net_snapshot.pth"]
    emit("train_cli_psp_net", run=out, files=files, ok=bool(ok))
    if not ok:
        raise AssertionError("train_cli_psp_net checks failed")
    return out["launches"]


class EpochTimer:
    """Stands in for the train CLI's epoch runners and times them: the host
    time of each train and validation epoch, synchronised at both ends, and
    in train epoch ``event_epoch`` a CUDA event pair around each step. It
    also counts the calls that make the host wait for the card in each train
    epoch (torch's sync debug mode): the epoch's one log fetch, never one per
    step."""

    def __init__(self, event_epoch=None):
        self.train_s, self.val_s, self.event_epoch, self.spans_ms = [], [], event_epoch, None
        self.syncs = []
        self.run_train, self.run_validate = train_cli.run_train_epoch, train_cli.run_validate_epoch

    def train(self, train_step, loader, lr, epoch, *args, **kwargs):
        step, pairs = train_step, []
        if epoch == self.event_epoch:
            def step(x, y, step_lr):
                pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                pair[0].record()
                logs = train_step(x, y, step_lr)
                pair[1].record()
                pairs.append(pair)
                return logs
            step.model = train_step.model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.run_train(step, loader, lr, epoch, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        self.train_s.append(time.perf_counter() - t0)
        self.syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        if pairs:
            self.spans_ms = [a.elapsed_time(b) for a, b in pairs]
            self.event_wall_ms = self.train_s[-1] * 1e3
        return out

    def validate(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.run_validate(*args, **kwargs)
        torch.cuda.synchronize()
        self.val_s.append(time.perf_counter() - t0)
        return out


def cli_run(label, argv, train_steps, val_batches, step_ms, event_epoch=None,
            main=train_cli.main, step_launches=STEP_LAUNCHES, eval_launches=EVAL_LAUNCHES,
            batch=TRAIN_BATCH):
    """One in-process run of the train CLI (or of ``main``, a trainer built
    on it) at ``batch`` with its launches, times and peak memory; fails
    unless the launches are the layer count: ``step_launches`` per train step
    and ``eval_launches`` per validation batch."""
    timer = EpochTimer(event_epoch)
    train_cli.run_train_epoch, train_cli.run_validate_epoch = timer.train, timer.validate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        history = main(argv)
    finally:
        train_cli.run_train_epoch, train_cli.run_validate_epoch = timer.run_train, timer.run_validate
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    expected = {k: train_steps * step_launches[k] + val_batches * eval_launches[k]
                for k in step_launches}
    steps_per_epoch = train_steps / len(timer.train_s)
    out = dict(run=label, argv=argv, epochs=history["epoch"], loss=history["loss"],
               val_loss=history["val_loss"], train_steps=train_steps, val_batches=val_batches,
               launches=launches, expected_launches=expected, seconds=seconds,
               train_epoch_s=timer.train_s, val_epoch_s=timer.val_s,
               images_per_s_train=train_steps * batch / sum(timer.train_s),
               images_per_s_with_val=(train_steps * batch
                                      / (sum(timer.train_s) + sum(timer.val_s))),
               ms_per_step=[t * 1e3 / steps_per_epoch for t in timer.train_s],
               train_phase_ms_per_step=step_ms, max_memory_allocated=torch.cuda.max_memory_allocated())
    if timer.spans_ms is not None:
        out.update(event_epoch=timer.event_epoch, steps_timed=len(timer.spans_ms),
                   step_span_ms_median=float(np.median(timer.spans_ms)),
                   idle_outside_steps_share=1 - sum(timer.spans_ms) / timer.event_wall_ms)
    out.update(host_syncs_per_train_epoch=timer.syncs)
    if (launches != expected or not all(np.isfinite(history["loss"] + history["val_loss"]))
            or max(timer.syncs) > EPOCH_SYNCS):
        raise AssertionError(f"train_cli {label}: launches {launches}, expected {expected}; "
                             f"losses {history['loss']} {history['val_loss']}; host syncs per "
                             f"train epoch {timer.syncs} for {steps_per_epoch} steps")
    return history, out


def loader_rate(workers: int, samples: int = 64) -> float:
    """Samples/s of the host SHAPES loader alone at batch 16, patch 512."""
    loader = DataLoader(Subset(ShapesDataset(1024, PATCH), samples), TRAIN_BATCH, shuffle=True,
                        workers=workers)
    t0 = time.perf_counter()
    n = sum(len(x) for x, _ in loader)
    return n / (time.perf_counter() - t0)


def phase_train_cli(step_ms: float, tmpdir: Path):
    """The train CLI's three runs (see the module docstring)."""
    exp = str(tmpdir / "experiments")
    base = CLI_ARGS + ["--experiments-dir", exp]
    name = f"shapes-device_linknet34_{PATCH}_rgb_bce_jaccard"
    d = tmpdir / "experiments" / "shapes-device" / "bce_jaccard" / name
    runs, launches = [], Counter()

    _, out = cli_run("a", base + ["-d", "shapes-device", "-e", "2"], 2 * CLI_STEPS,
                     2 * CLI_VAL_BATCHES, step_ms, event_epoch=1)
    runs.append(out)
    launches.update(out["launches"])
    ckpt = d / "linknet34_checkpoint.pth"
    resume_from = torch.load(ckpt, map_location="cpu", weights_only=False)["epoch"] + 1
    print("train_cli (b) resumes from epoch", resume_from, flush=True)
    history_b, out = cli_run("b", base + ["-d", "shapes-device", "-e", "3", "-r"],
                             (3 - resume_from) * CLI_STEPS, (3 - resume_from) * CLI_VAL_BATCHES,
                             step_ms)
    out["resumed_from_epoch"] = resume_from
    runs.append(out)
    launches.update(out["launches"])
    rate = loader_rate(4)
    _, out = cli_run("c", base + ["-d", "shapes", "-w", "4", "-s", "4", "-e", "1"], 4, 1, step_ms)
    out["loader_samples_per_s"] = rate
    runs.append(out)
    launches.update(out["launches"])

    csv_lines = (d / f"{name}.csv").read_text().splitlines()
    model = get_model("linknet34", patch_size=PATCH, device="cuda")
    opt = get_optimizer("adam", model.parameters(), TRAIN_LR)
    start, _, best = restore_snapshot(str(ckpt), model, opt)
    n_params = len(list(model.parameters()))
    opt_ok = (len(opt.state) == n_params
              and all(v["exp_avg"].device == p.device for p, v in opt.state.items()))
    files_ok = all((d / f).exists() for f in ("arguments.txt", "linknet34_checkpoint.pth",
                                              "linknet34_snapshot.pth"))
    best_epoch = int(np.argmin(history_b["val_loss"]))
    ok = (history_b["epoch"] == [0, 1, 2] and len(csv_lines) == 1 + 2 + 3 and files_ok and opt_ok
          and start == best_epoch + 1 and best == min(history_b["val_loss"]))
    emit("train_cli", runs=runs, resumed_from_epoch=resume_from, csv_lines=len(csv_lines),
         best_checkpoint=dict(epoch=start - 1, loss=best, optimizer_tensors=len(opt.state),
                              parameters=n_params),
         launches=dict(launches), ok=bool(ok))
    if not ok:
        raise AssertionError("train_cli checks failed")
    return dict(launches)


# The afterburner stack: LinkNet34's launches plus the 18 BatchNorms of the
# afterburner's UNet (36, 18, 0); in eval mode only LinkNet34's InPlaceABNs.
AB_STEP_LAUNCHES = {k: STEP_LAUNCHES[k] + MODEL_STEP_LAUNCHES["unet"][k] for k in STEP_LAUNCHES}
AB_STEPS = 8


def phase_train_ab_cli(step_ms: float, tmpdir: Path):
    """The afterburner CLI on the head that train_cli's shapes-device runs
    left as their best checkpoint, from that run's directory (the CLI finds
    ``linknet34_checkpoint.pth`` by a recursive search from the working
    directory)."""
    head_dir = (tmpdir / "experiments" / "shapes-device" / "bce_jaccard"
                / f"shapes-device_linknet34_{PATCH}_rgb_bce_jaccard")
    head, _ = load_snapshot(str(head_dir / "linknet34_checkpoint.pth"))
    argv = CLI_ARGS + ["--experiments-dir", str(tmpdir / "ab"), "-d", "shapes-device", "-e", "1",
                       "-s", str(AB_STEPS)]
    cwd = os.getcwd()
    os.chdir(head_dir)
    try:
        history, out = cli_run("ab", argv, AB_STEPS, max(AB_STEPS // 4, 1), step_ms,
                               main=train_ab_cli.main, step_launches=AB_STEP_LAUNCHES)
    finally:
        os.chdir(cwd)
    after, _ = load_snapshot(str(next((tmpdir / "ab").rglob("linknet34_snapshot.pth"))))
    stack = train_ab_cli._model_builder(train_cli.build_arg_parser().parse_args(argv), 3)
    start, params = stack.state_dict(), {n for n, _ in stack.named_parameters()}
    head_params = [k for k in head if "head." + k in params]
    head_stats = [k for k in head if k.endswith(("running_mean", "running_var"))]
    ab_params = [k for k in params if k.startswith("afterburner.")]
    frozen = sum(torch.equal(after["head." + k], head[k]) for k in head_params)
    stats_moved = sum(not torch.equal(after["head." + k], head[k]) for k in head_stats)
    ab_moved = sum(not torch.equal(after[k], start[k]) for k in ab_params)
    ok = (frozen == len(head_params) and stats_moved == len(head_stats)
          and ab_moved == len(ab_params) and history["epoch"] == [0])
    emit("train_ab_cli", run=out, head_parameters=len(head_params), head_parameters_unchanged=frozen,
         head_running_stats=len(head_stats), head_running_stats_moved=stats_moved,
         afterburner_parameters=len(ab_params), afterburner_parameters_moved=ab_moved,
         ok=bool(ok))
    if not ok:
        raise AssertionError("train_ab_cli checks failed")
    return out["launches"]


def phase_train_cli_albunet(step_ms: float, tmpdir: Path):
    """The train CLI on albunet-finetune-512's recipe: ``albunet
    --freeze-encoder -d shapes-device -s 2 -e 1`` (2 train steps, 1
    validation batch; eval-mode BatchNorm runs no kernel of this repo). The
    last .pth holds every encoder parameter as initialised; the head moved."""
    exp = tmpdir / "albunet"
    argv = ["-m", "albunet", "-l", "bce", "-o", "adam", "-lr", "1e-3", "-b", str(TRAIN_BATCH),
            "-p", str(PATCH), "--bf16", "--no-tensorboard", "--seed", "0", "--freeze-encoder",
            "-d", "shapes-device", "-s", "2", "-e", "1", "--experiments-dir", str(exp)]
    history, out = cli_run("albunet", argv, 2, 1, step_ms,
                           step_launches=MODEL_STEP_LAUNCHES["albunet"], eval_launches=NO_LAUNCHES)
    after, _ = load_snapshot(str(next(exp.rglob("albunet_snapshot.pth"))))
    initial = get_model("albunet", patch_size=PATCH, device="cpu")
    before = initial.state_dict()
    encoder = [n for n, _ in initial.named_parameters() if n.startswith(ENCODER_PREFIXES["albunet"])]
    unchanged = sum(torch.equal(after[n], before[n]) for n in encoder)
    head_moved = not torch.equal(after["final.weight"], before["final.weight"])
    ok = unchanged == len(encoder) == 108 and head_moved and history["epoch"] == [0]
    emit("train_cli_albunet", run=out, encoder_parameters=len(encoder),
         encoder_parameters_unchanged=unchanged, head_moved=head_moved, ok=bool(ok))
    if not ok:
        raise AssertionError("train_cli_albunet checks failed")
    return out["launches"]


# The nuclei A/B's per-step launches; eval-mode BatchNorm runs no kernel of
# this repo, so ZF_UNET's validation launches none.
NUCLEI_LAUNCHES = {"zf_unet": (MODEL_STEP_LAUNCHES["zf_unet"], NO_LAUNCHES),
                   "linknet34": (STEP_LAUNCHES, EVAL_LAUNCHES)}


def nuclei_loader_rate(data_dir: Path, seed: int) -> float:
    """Samples/s of one seeded epoch of the host loader alone over the
    fixture's train patches (batch 8, 4 threads, the train augmentations)."""
    train, _, _ = get_dataset("dsb2018", str(data_dir), patch_size=ab_nuclei.PATCH)
    loader = DataLoader(train, ab_nuclei.BATCH, shuffle=True, workers=4, seed=seed,
                        sample_seed=seed)
    t0 = time.perf_counter()
    n = sum(len(x) for x, _ in loader)
    return n / (time.perf_counter() - t0)


def phase_train_nuclei(card: str, tmpdir: Path, ab_out=None):
    """The nuclei-fixture accuracy A/B (``python -m segtpu_torch.ab_nuclei``):
    six legs of the train CLI on the card, each counted and checked as a
    train_cli run, then the port's val-IoU band of each config against the
    committed torch band; fails when the band falls below it at an epoch of
    the second half."""
    import cv2

    legs, launches, sizes, flags = {m: [] for m in NUCLEI_LAUNCHES}, Counter(), {}, set()

    def run_leg(argv, model):
        flags.add((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.deterministic))
        if not sizes:
            data_dir = argv[argv.index("-dd") + 1]
            train, valid, _ = get_dataset("dsb2018", data_dir,
                                                    patch_size=ab_nuclei.PATCH)
            sizes.update(train=len(train), valid=len(valid))
        per_epoch = sizes["train"] // ab_nuclei.BATCH, sizes["valid"] // ab_nuclei.BATCH
        step, evals = NUCLEI_LAUNCHES[model]
        seed = int(argv[argv.index("--seed") + 1])
        history, out = cli_run(f"{model}_s{seed}", argv, ab_nuclei.EPOCHS * per_epoch[0],
                               ab_nuclei.EPOCHS * per_epoch[1], None, step_launches=step,
                               eval_launches=evals, batch=ab_nuclei.BATCH)
        launches.update(out["launches"])
        out.update(steps_per_s=out["train_steps"] / sum(out["train_epoch_s"]),
                   history=history)
        legs[model].append(out)
        for f in Path(argv[argv.index("--experiments-dir") + 1]).rglob("*.pth"):
            f.unlink()

    t0 = time.perf_counter()
    verdicts = ab_nuclei.run(tmpdir / "ab_nuclei", ab_out, run_leg=run_leg, card=card)
    seconds = time.perf_counter() - t0
    tf32 = dict(zip(("cudnn_allow_tf32", "matmul_allow_tf32", "cudnn_deterministic"),
                    map(list, zip(*flags))))
    repeat = repeat_leg(legs["linknet34"][0], tmpdir / "ab_nuclei_repeat")
    loader = nuclei_loader_rate(tmpdir / "ab_nuclei" / "data" / "dsb2018", ab_nuclei.RUN_SEEDS[0])
    for model, v in verdicts.items():
        runs = legs[model]
        emit("train_nuclei", config=model, epochs=v["epochs"], ok=v["ok"],
             bands=[{k: r[k] for k in ("epoch", "torch", "port", "segtpu", "relation")}
                    for r in v["rows"]],
             final=v["final"], delta_vs_torch=v["delta_vs_torch"],
             delta_vs_segtpu=v["delta_vs_segtpu"],
             steps_per_s=sum(r["train_steps"] for r in runs) / sum(sum(r["train_epoch_s"])
                                                                  for r in runs),
             loader_samples_per_s=loader, **tf32, cv2_version=cv2.__version__,
             train_set=sizes["train"], valid_set=sizes["valid"],
             legs=[{k: r[k] for k in ("run", "seconds", "steps_per_s", "images_per_s_train",
                                      "images_per_s_with_val", "train_steps", "val_batches",
                                      "launches", "expected_launches", "max_memory_allocated",
                                      "host_syncs_per_train_epoch")} for r in runs])
    ok = all(v["ok"] for v in verdicts.values())
    emit("train_nuclei", seconds=seconds, launches=dict(launches), repeat=repeat,
         written_to=None if ab_out is None else str(ab_out), ok=ok)
    if not ok:
        raise AssertionError("train_nuclei: the port's val-IoU band falls below the torch band "
                             "at an epoch of the second half")
    if flags != {(False, False, True)}:
        raise AssertionError(f"train_nuclei: legs ran with TF32 or nondeterministic cuDNN: {tf32}")
    return dict(launches)


def repeat_leg(leg: dict, exp_dir: Path, epochs: int = 2) -> dict:
    """The first ``epochs`` epochs of ``leg`` again, in a new experiments
    directory, under the A/B's precision: whether the train loss, val loss
    and val IoU of each epoch repeat the leg's bits. Its launches are not
    part of the path's count."""
    argv = list(leg["argv"])
    argv[argv.index("-e") + 1] = str(epochs)
    argv[argv.index("--experiments-dir") + 1] = str(exp_dir)
    with ab_nuclei.reference_precision():
        history = train_cli.main(argv)
    keys = ("loss", "val_loss", "val_iou")
    first = {k: leg["history"][k][:epochs] for k in keys}
    again = {k: history[k] for k in keys}
    return dict(run=leg["run"], epochs=epochs, same_bits=first == again, leg=first, again=again)


# --device-augs (segtpu_torch.augment.device): augment_parity's batch, the
# train CLI's runs on raw SHAPES and the nuclei fixture.
AUG_BATCH = 16
AUG_STEPS = 8
AUG_VAL_BATCHES = max(AUG_STEPS // 4, 1)
# gates of augment_parity, the card against the CPU on the same parameters
# (0-255 pixels): bit-equal; a warp (the coordinates go through cos and
# sin, whose fp32 results differ by an ulp between the card and the CPU);
# brightness, contrast, saturation, filter (a reduction's order); HSV
AUG_TOL = {"exact": 0.0, "warp": 1e-2, "photometric": 1e-4, "hsv": 1e-3}


def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


def augment_cases(n, h, w):
    """``(name, gate, draw(generator), apply(x, m, params) -> outputs)`` of
    every op and pipeline of segtpu_torch.augment.device."""
    from segtpu_torch.augment import device as A
    fire = lambda g: A.draw_fire(g, n)
    return [
        ("vertical_flip", "exact", fire, A.vertical_flip),
        ("horizontal_flip", "exact", fire, A.horizontal_flip),
        ("transpose", "exact", fire, A.transpose),
        ("rotate90", "exact", lambda g: A.draw_rotate90(g, n), A.rotate90),
        ("crop", "exact", lambda g: A.draw_crop(g, n, h, w, h - 64),
         lambda x, m, p: A.crop(x, m, p, h - 64)),
        ("center_crop", "exact", lambda g: {}, lambda x, m, p: A.center_crop(x, m, h - 64)),
        ("invert", "exact", fire, lambda x, m, p: (A.invert(x, p),)),
        ("grayscale", "exact", fire, lambda x, m, p: (A.grayscale(x, p),)),
        ("normalize", "exact", lambda g: {}, lambda x, m, p: (A.normalize(x), A.make_binary(m))),
        ("shift_scale_rotate", "warp",
         lambda g: A.draw_shift_scale_rotate(g, n, h, w, prob=1.0), A.shift_scale_rotate),
        ("rotate", "warp", lambda g: A.draw_shift_scale_rotate(
            g, n, h, w, shift_limit=0.0, scale_limit=0.0, rotate_limit=90.0, prob=1.0),
         A.shift_scale_rotate),
        ("shift", "warp", lambda g: A.draw_shift(g, n, prob=1.0), A.shift),
        ("shift_scale", "warp", lambda g: A.draw_shift_scale(g, n, w, prob=1.0), A.shift_scale),
        ("brightness", "photometric", lambda g: A.draw_alpha(g, n, 0.9, 1.1, prob=1.0),
         lambda x, m, p: (A.brightness(x, p),)),
        ("contrast", "photometric", lambda g: A.draw_alpha(g, n, 0.9, 1.1, prob=1.0),
         lambda x, m, p: (A.contrast(x, p),)),
        ("saturation", "photometric", lambda g: A.draw_alpha(g, n, 0.7, 1.3, prob=1.0),
         lambda x, m, p: (A.saturation(x, p),)),
        ("filter", "photometric", lambda g: A.draw_alpha(g, n, 0.0, 0.5, prob=1.0, identity=0.0),
         lambda x, m, p: (A.blur_filter(x, p),)),
        ("hsv_shift", "hsv", lambda g: A.draw_hsv_shift(g, n, prob=1.0),
         lambda x, m, p: (A.hsv_shift(x, p),)),
        ("clahe", "clahe", lambda g: {}, lambda x, m, p: (A.clahe(x),)),
        ("pipeline_shapes", "exact", lambda g: {},
         lambda x, m, p: A.shapes_train_pipeline(None, x, m)),
        ("pipeline_dsb2018", "warp", lambda g: A.dsb2018_draw(g, n, h, w), A.dsb2018_apply),
        ("pipeline_inria", "warp", lambda g: A.inria_draw(g, n, h, w), A.inria_apply),
    ]


def _aug_error(name, gate, got, want, x_scale):
    """The largest error of each output of one op, the card's against the
    CPU's, on the 0-255 scale (``x_scale``: 255 x std where the op
    normalises); a mask after a warp: binarised, a mismatch only where the
    CPU's warped value lies within 1e-3 of the threshold. Raises where an
    output is out of its gate."""
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        mask = i == 1
        if gate == "clahe":
            err = (a - b).abs()
            share = float((err > 1e-3).float().mean())
            errs.append(dict(max=float(err.max()), share_over_1e3=share))
            if float(err.max()) > 1.0 or share > 1e-3:
                raise AssertionError(f"augment_parity {name}: CLAHE off by {float(err.max())} "
                                     f"on {share} of the pixels")
            continue
        if mask and name.startswith("pipeline_") and gate == "warp":
            # binarised masks: compare with the CPU's soft mask kept by the caller
            bad = int((a != b).sum())
            errs.append(dict(mismatches=bad))
            continue
        scale = 1.0 if mask else x_scale
        err = float(((a.double() - b.double()).abs() * scale).max())
        limit = AUG_TOL[gate] * (1.0 / 255 if mask and gate == "warp" else 1.0)
        errs.append(dict(max=err))
        if err > limit or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"augment_parity {name} output {i}: error {err} > {limit}")
    return errs


def phase_augment_parity(step_ms: float):
    """Every op and pipeline of the device augmentations on the card against
    the CPU, the same parameters (drawn on the CPU) on the same 16x3x512^2
    fp32 0-255 pixels and 0/1 masks, by AUG_TOL; then each pipeline's
    device ms per batch (its draws and applies, medians of 20) beside the
    LinkNet34 training step's ms (train phase). No kernel of this repo
    runs."""
    from segtpu_torch.augment import device as A
    n, side = AUG_BATCH, PATCH
    rng = np.random.default_rng(SEED + 60)
    x = torch.from_numpy(rng.integers(0, 256, (n, 3, side, side)).astype(np.float32))
    m = torch.from_numpy((rng.random((n, 1, side, side)) > 0.5).astype(np.float32))
    xc = x.cuda().contiguous(memory_format=torch.channels_last)
    mc = m.cuda().contiguous(memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(SEED + 61)
    kernels.reset_launch_counts()
    results = {}
    for name, gate, draw, apply in augment_cases(n, side, side):
        p = draw(g)
        want = apply(x, m, p)
        got = apply(xc, mc, _to(p, "cuda"))
        torch.cuda.synchronize()
        std = {"pipeline_dsb2018": A.IMAGENET_STD, "pipeline_inria": A.INRIA_STD,
               "pipeline_shapes": A.IMAGENET_STD, "normalize": A.IMAGENET_STD}.get(name)
        x_scale = 1.0 if std is None else 255.0 * float(max(std))
        results[name] = dict(gate=gate, outputs=_aug_error(name, gate, got, want, x_scale))
        if name in ("pipeline_dsb2018", "pipeline_inria"):
            # the CPU's mask before binarisation: the pipeline with the threshold moved
            soft = {"pipeline_dsb2018": _soft_dsb2018, "pipeline_inria": _soft_inria}[name](
                A, x, m, p)
            differ = got[1].cpu() != want[1]
            near = soft.abs() <= 1e-3
            bad = int((differ & ~near).sum())
            results[name]["mask_mismatches_off_threshold"] = bad
            results[name]["mask_mismatches_at_threshold"] = int((differ & near).sum())
            if bad:
                raise AssertionError(f"augment_parity {name}: {bad} mask pixels differ away "
                                     "from the threshold")
        del want, got
    launches = kernels.launch_counts()
    gc = torch.Generator(device="cuda").manual_seed(SEED + 62)
    pipelines = {name: A.get_device_pipelines(name)[0] for name in ("shapes", "dsb2018", "inria")}
    ms = {name: cuda_ms(lambda fn=fn: fn(gc, xc, mc)) for name, fn in pipelines.items()}
    ok = launches == NO_LAUNCHES
    emit("augment_parity", batch=[n, 3, side, side], ops=results, tolerance=AUG_TOL,
         pipeline_ms_per_batch=ms, linknet34_step_ms=step_ms,
         pipeline_share_of_step={k: v / step_ms for k, v in ms.items()},
         kernel_launches=launches, ok=ok)
    if not ok:
        raise AssertionError(f"augment_parity: the augmentations launched {launches}")


def _soft_dsb2018(A, x, m, p):
    x = A.normalize(x)
    x, m = A.rotate90(x, m, p["rotate90"])
    x, m = A.vertical_flip(x, m, p["vflip"])
    x, m = A.horizontal_flip(x, m, p["hflip"])
    return A.shift_scale_rotate(x, m, p["ssr"])[1]


def _soft_inria(A, x, m, p):
    x, m = A.vertical_flip(x, m, p["vflip"])
    x, m = A.horizontal_flip(x, m, p["hflip"])
    return A.shift_scale_rotate(x, m, p["ssr"])[1]


class AugmentRecorder:
    """Wraps the train CLI's ``make_train_step`` so that each step's
    augmentation records its generator's seed (host) and the sums of its
    augmented images and masks (device, fetched after the run)."""

    def __init__(self):
        self.seeds, self.sums = [], []
        self.real = train_cli.make_train_step

    def __enter__(self):
        def make(*args, augment_fn=None, **kwargs):
            def augment(g, x, y):
                self.seeds.append(g.initial_seed())
                out = augment_fn(g, x, y)
                self.sums.append(torch.stack([t.sum(dtype=torch.float64) for t in out]))
                return out
            return self.real(*args, augment_fn=augment if augment_fn else None, **kwargs)
        train_cli.make_train_step = make
        return self

    def __exit__(self, *exc):
        train_cli.make_train_step = self.real

    def fetch(self):
        return torch.stack(self.sums).cpu().tolist() if self.sums else []


# The resumed epoch's loss against the unbroken run's, with cuDNN held to
# deterministic algorithms: 0.0 apart once dropout was keyed by step, 1.56e-3
# when the resumed run drew other dropout masks (0.36507 against 0.36564,
# H100).
RESUME_RTOL = 1e-6


def phase_train_cli_device_augs(step_ms: float, tmpdir: Path):
    """``-m linknet34 -d shapes --device-augs`` through the train CLI at
    full width (batch 16, patch 512, bf16, Adam), cuDNN deterministic: (a) 2
    epochs of 8 steps; (b) 1 epoch in a new directory, then (c) ``-r -e 2``
    there: its second epoch must draw (a)'s: the same generator seed at each
    step and the same sums of the augmented batches, and give (a)'s second
    epoch loss to RESUME_RTOL. Launches per step the layer count
    (the augmentation adds none), the host's waits per train epoch at most
    EPOCH_SYNCS, losses finite and (a)'s second epoch below its first."""
    base = CLI_ARGS + ["-d", "shapes", "--device-augs", "-s", str(AUG_STEPS), "-w", "4"]
    runs, launches, recorded = [], Counter(), {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, exp, extra, epochs in (("a", "a", ["-e", "2"], 2), ("b", "b", ["-e", "1"], 1),
                                          ("c", "b", ["-e", "2", "-r"], 1)):
            with AugmentRecorder() as rec:
                history, out = cli_run(label,
                                       base + extra + ["--experiments-dir", str(tmpdir / exp)],
                                       epochs * AUG_STEPS, epochs * AUG_VAL_BATCHES, step_ms)
            recorded[label] = (rec.seeds, rec.fetch())
            out["augment_seeds"] = rec.seeds
            runs.append(out)
            launches.update(out["launches"])
    finally:
        torch.backends.cudnn.deterministic = saved
    a_seeds, a_sums = recorded["a"]
    c_seeds, c_sums = recorded["c"]
    repeats = c_seeds == a_seeds[AUG_STEPS:] and c_sums == a_sums[AUG_STEPS:]
    falling = runs[0]["loss"][1] < runs[0]["loss"][0]
    # dropout is keyed by step as the augmentations are (ROADMAP C1), and
    # cuDNN is deterministic: the resumed epoch repeats the unbroken one's loss
    resumed_diff = abs(runs[2]["loss"][-1] - runs[0]["loss"][-1]) / abs(runs[0]["loss"][-1])
    ok = repeats and falling and runs[2]["epochs"] == [0, 1] and resumed_diff <= RESUME_RTOL
    emit("train_cli_device_augs", runs=runs, resumed_draws_repeat=repeats,
         resumed_epoch_loss=runs[2]["loss"][-1], unbroken_epoch_loss=runs[0]["loss"][-1],
         resumed_loss_rel_diff=resumed_diff, resumed_loss_rtol=RESUME_RTOL,
         loss_falls=falling, launches=dict(launches), ok=bool(ok))
    if not ok:
        raise AssertionError("train_cli_device_augs checks failed")
    return dict(launches)


def phase_nuclei_device_augs(data_dir: Path, tmpdir: Path):
    """``-d dsb2018`` on the nuclei fixture that train_nuclei wrote
    (linknet34, bce_jaccard, Adam lr 1e-4, patch 128, batch 8, fp32): 1
    epoch with the host augmentations, then 2 with ``--device-augs``, each
    counted as a train_cli run, their images/s side by side; then 1 epoch
    with ``--device-augs`` in a new directory and ``-r -e 2`` there, whose
    second epoch must draw what the unbroken run drew (as
    train_cli_device_augs)."""
    train, valid, _ = get_dataset("dsb2018", str(data_dir), patch_size=ab_nuclei.PATCH)
    per_epoch = len(train) // ab_nuclei.BATCH, len(valid) // ab_nuclei.BATCH
    argv = ["-m", "linknet34", "-d", "dsb2018", "-dd", str(data_dir), "-p", str(ab_nuclei.PATCH),
            "-b", str(ab_nuclei.BATCH), "-l", "bce_jaccard", "-o", "adam", "-lr", "1e-4",
            "--seed", str(ab_nuclei.RUN_SEEDS[0]), "--no-tensorboard", "--light-logging"]
    runs, launches, recorded = {}, Counter(), {}
    for label, exp, extra, epochs in (
            ("host", "host", ["-e", "1"], 1), ("device", "device", ["-e", "2", "--device-augs"], 2),
            ("device_b", "device_b", ["-e", "1", "--device-augs"], 1),
            ("device_resumed", "device_b", ["-e", "2", "-r", "--device-augs"], 1)):
        with AugmentRecorder() as rec:
            _, out = cli_run(f"nuclei_{label}", argv + extra + ["--experiments-dir",
                                                                str(tmpdir / exp)],
                             epochs * per_epoch[0], epochs * per_epoch[1], None,
                             batch=ab_nuclei.BATCH)
        recorded[label] = (rec.seeds, rec.fetch())
        runs[label] = out
        if label != "host":
            launches.update(out["launches"])
    seeds, sums = recorded["device"]
    repeats = (recorded["device_resumed"] == (seeds[per_epoch[0]:], sums[per_epoch[0]:])
               and len(set(seeds)) == len(seeds) == 2 * per_epoch[0])
    rate = {k: runs[k]["images_per_s_train"] for k in ("host", "device")}
    emit("train_nuclei_device_augs", train_set=len(train), valid_set=len(valid),
         runs=list(runs.values()), images_per_s_train=rate,
         device_over_host=rate["device"] / rate["host"], resumed_draws_repeat=repeats,
         launches=dict(launches), ok=bool(repeats))
    if not repeats:
        raise AssertionError("train_nuclei_device_augs: the resumed run drew other augmentations")
    return dict(launches)


# WideResNet-28-10 (segtpu_torch.models.wider_resnet): 25 BatchNorms; batch
# 32 (128 before: the CPU's fp32 and float64 steps took 43-60 s)
WRN_BATCH, WRN_SIDE = 32, 32
WRN_LAUNCHES = step_launches(25, 0)


def phase_wider_resnet():
    """One fp32 SGD step (lr 0.01, cross-entropy over 10 classes) of
    WideResNet(depth=28, widen_factor=10), seeded, at 32x3x32^2: the card
    (TF32 off) against the CPU and the CPU in float64, by parity_verdict's
    gates; launches per step (50, 25, 0)."""
    from segtpu_torch.models import place_model
    from segtpu_torch.models.wider_resnet import WideResNet

    rng = np.random.default_rng(SEED + 70)
    x = torch.from_numpy(rng.standard_normal((WRN_BATCH, 3, WRN_SIDE, WRN_SIDE),
                                             dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, WRN_BATCH))
    runs = {}
    t0 = time.perf_counter()
    with fp32_convolutions():
        for key, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                   ("cpu_f64", "cpu", torch.float64)):
            model = WideResNet(depth=28, widen_factor=10)
            layers_mod.reset_parameters(model, torch.Generator().manual_seed(SEED))
            model = place_model(model, device).to(dtype)
            step = make_train_step(model, get_optimizer("sgd", model.parameters(), PARITY_LR),
                                   F.cross_entropy)
            kernels.reset_launch_counts()
            logs = step(x.to(device, dtype), labels.to(device), PARITY_LR)
            launches = None
            if device == "cuda":
                torch.cuda.synchronize()
                launches = kernels.launch_counts()
            runs[key] = (float(logs["loss"]),
                         {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                         {k: v.detach().cpu() for k, v in model.state_dict().items()}, launches)
            del model, step
    fields, ok = parity_verdict(runs, WRN_LAUNCHES)
    emit("wider_resnet", input=[WRN_BATCH, 3, WRN_SIDE, WRN_SIDE], depth=28, widen_factor=10,
         lr=PARITY_LR, seconds=time.perf_counter() - t0, **fields, ok=ok)
    if not ok:
        raise AssertionError("wider_resnet failed")
    return runs["card"][3]


LR_FINDER_STEPS = 30


def phase_lr_finder(tmpdir: Path):
    """``segtpu_torch.lr_finder``'s entry point as a user calls it, in this
    process (a new one cost 5-8 s of start-up): LinkNet34 on shapes-device
    at batch 16, patch 512, bce_jaccard, Adam: 30 steps, then the smoothed
    plot. Gates: 30 finite losses, a PNG written."""
    out = tmpdir / "loss_plot.png"
    argv = ["-m", "linknet34", "-d", "shapes-device", "-l", "bce_jaccard", "-o", "adam",
            "-b", str(TRAIN_BATCH), "-p", str(PATCH), "--out", str(out)]
    printed, error, losses = io.StringIO(), "", []
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            _, losses = lr_finder.main(argv)
    except (Exception, SystemExit):  # reported below, then the phase fails
        error = traceback.format_exc()[-400:]
    seconds = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    png = out.exists() and out.read_bytes()[:4] == b"\x89PNG"
    ok = (not error and len(losses) == LR_FINDER_STEPS and all(np.isfinite(losses)) and png
          and f"saved {out}" in printed.getvalue())
    emit("lr_finder", seconds=seconds, steps=len(losses),
         first_loss=losses[0] if losses else None, last_loss=losses[-1] if losses else None,
         min_loss=min(losses) if losses else None, png_written=png, error=error, ok=bool(ok))
    if not ok:
        raise AssertionError("lr_finder failed")


def busy_share(trace_path: Path) -> dict:
    """The device's busy and idle share over a torch.profiler Chrome trace:
    the union of its kernels, copies and sets against the span of all its
    events."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    span = max(float(e["ts"]) + float(e["dur"]) for e in events) - min(float(e["ts"]) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    return dict(span_ms=span / 1e3, busy_ms=busy / 1e3, device_events=len(device),
                idle_share=1 - busy / span)


def phase_cli_profile(tmpdir: Path):
    """The train CLI's --profile-dir on the card: one shapes-device epoch of
    8 steps under torch.profiler, and the device's idle share over it."""
    prof = tmpdir / "profile"
    train_cli.main(CLI_ARGS + ["--experiments-dir", str(tmpdir / "profiled"), "-d", "shapes-device",
                               "-e", "1", "-s", "8", "--profile-dir", str(prof)])
    traces = list(prof.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"cli_profile: {len(traces)} traces written")
    share = busy_share(traces[0])
    emit("cli_profile", steps=8, trace_bytes=traces[0].stat().st_size, **share,
         note="under torch.profiler, which slows the host's launches", ok=share["device_events"] > 0)
    if share["device_events"] == 0:
        raise AssertionError("cli_profile: the trace holds no device events")


def phase_one_launch(norm_shapes):
    """One call of B1 (both forms), of B2 and of B3 runs exactly one device
    kernel, at the largest and the smallest shape of the step, by
    torch.profiler.
    Last of the phases that use the card: a profiler session leaves CUPTI
    attached to the process, which slows every later launch."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    unique = sorted(_unique(norm_shapes, ("bn", "abn")), key=lambda s: int(np.prod(s)))
    abn_unique = sorted(_unique(norm_shapes, ("abn",)), key=lambda s: int(np.prod(s)))
    fns = {}
    for label, shape in (("smallest", unique[0]), ("largest", unique[-1])):
        a = cuda_input(shape, torch.bfloat16, "channels_last", g)
        b = cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0)
        fns[f"channel_sums {label} single"] = lambda a=a: kernels.channel_sums_cuda(a)
        fns[f"channel_sums {label} pair"] = lambda a=a, b=b: kernels.channel_sums_cuda(a, b)
    for label, shape in (("smallest", abn_unique[0]), ("largest", abn_unique[-1])):
        z, grad, gamma, beta = _abn_output(shape, torch.bfloat16, "channels_last", "leaky_relu", g)
        fns[f"abn_bwd {label}"] = (lambda z=z, grad=grad, gamma=gamma, beta=beta:
                                   kernels.abn_bwd_sums_cuda(z, grad, gamma, beta, "leaky_relu",
                                                             SLOPE))
    for label, shape in (("smallest", unique[0]), ("largest", unique[-1])):
        x = cuda_input(shape, torch.bfloat16, "channels_last", g)
        scale = torch.rand(shape[1], device="cuda", generator=g) + 0.5
        shift = torch.randn(shape[1], device="cuda", generator=g)
        fns[f"abn_norm_act {label}"] = (lambda x=x, scale=scale, shift=shift:
                                        kernels.abn_norm_act_cuda(x, scale, shift, "none", SLOPE))
    names = check_one_launch("kernel", fns)
    emit("one_launch", device_kernels_per_call={k: 1 for k in names}, kernels=names, ok=True)


def kernel_entry(kid, name, replaces, launches, max_err, timing, **extra):
    return {"id": kid, "name": name, "checked": True, "route": "cuda",
            "source": f"segtpu_torch/csrc/{kernels.SOURCES[name]}", "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
            "shape": timing["shape"], "dtype": "bfloat16", "layout": "channels_last", **extra}


def _per_step_entry(per_step):
    """The modelled per-step sums of each model for the kernel table (see
    :func:`step_sum`): calls x cold time against calls x bound."""
    keys = ("calls_modelled", "ms_modelled_cold", "bound_ms_modelled", "plain_ms_modelled_cold",
            "library_ms_modelled_cold", "library_calls_modelled",
            "ms_modelled_cold_of_library_calls", "library_by_call_modelled_cold")
    return {model: {k: sums[k] for k in keys if k in sums} for model, sums in per_step.items()}


# ---------------------------------------------------------------------------
# s2d execution, Tiramisu's packed growth and conv_in, the host tile I/O
# ---------------------------------------------------------------------------

# The s2d forms whose normalisation inputs kernel_s2d checks, at their
# training batch and patch 512: segtpu's bench form of zf_unet-512, UNetABN
# (B3 on grouped statistics), tiramisu67 and tiramisu57 (block-wise parts
# of 4 * (48 + 16k) and 4 * (48 + 12k) channels) and LinkNext's stem.
S2D_MODELS = {"zf_unet": TRAIN_BATCH, "unet_abn": TRAIN_BATCH, "tiramisu67": TIRAMISU_BATCH,
              "tiramisu57": TIRAMISU_BATCH, "linknext": ZOO_BATCH["linknext"]}
# train_s2d: segtpu's two s2d bench configs and UNetABN, in turns normal,
# s2d, s2d, normal; each run 3 warm and S2D_STEPS timed steps
S2D_CONFIGS = (("zf_unet-512", "zf_unet", "bce", "sgd", False),
               ("unet11-finetune-512", "unet11", "bce", "adam", True),
               ("unet_abn-512", "unet_abn", "bce_jaccard", "adam", False))
S2D_STEPS = 5
# train_tiramisu_a18: tiramisu67-512-b4 with segtpu's A18 options, 2 warm
# and A18_STEPS timed steps each, concat first and last
A18_VARIANTS = (("concat", {}), ("packed", dict(packed=True)),
                ("conv_in", dict(remat_policy="conv_in")),
                ("packed_conv_in", dict(packed=True, remat_policy="conv_in")), ("concat_again", {}))
A18_STEPS = 3
# tiramisu67 under remat_policy="conv_in": the BatchNorms of its 55 dense
# layers run their forward again in the backward (B1 3 and B2 2 per layer),
# its 5 transitions' as without it
CONV_IN_LAUNCHES = {"channel_sums": 55 * 3 + 5 * 2, "abn_norm_act": 55 * 2 + 5, "abn_bwd": 0}
# BatchNorm inputs that packed growth copies per forward: each dense layer's
# strided prefix of its block's buffer (B1 and B2 take dense inputs only)
PACKED_COPIES = 55


def s2d_step_shapes():
    """``{model: step_norm_shapes}`` of the s2d forms of S2D_MODELS."""
    return {m: step_norm_shapes(b, PATCH, model_name=m, s2d=True) for m, b in S2D_MODELS.items()}


def conv_gflop_per_image(name, attrs):
    """Forward convolution GFLOP (2 per MAC) of one 512x512 image through the
    seeded ``name`` with ``attrs`` set, counted by torch's FlopCounterMode on
    the CPU at 64x64 and scaled by the pixel count (every layer's work is
    proportional to it)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = seeded_model("cpu", name=name)
    for attr, value in attrs.items():
        setattr(model, attr, value)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    return counter.get_total_flops() * (PATCH // 64) ** 2 / 1e9


def phase_kernel_s2d(card: str, s2d_shapes, normal_shapes, checked):
    """B1 (both forms) and B2 (none and leaky_relu) against their plain
    versions at every normalisation input shape of the s2d forms' steps that
    the earlier kernel phases did not check (``checked``), B3 (leaky_relu)
    at every InPlaceABN input of the s2d steps, bf16 channels_last; then the
    largest shape of each s2d level (a call of the s2d form's step that its
    normal form's step, ``normal_shapes``, does not make) timed beside the plain
    versions and the library calls (warm medians of 20). Returns
    ``{kernel: entry}`` for the kernel table."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    unique = [s for s in _unique(s2d_shapes, ("bn", "abn")) if s not in checked]
    abn_unique = _unique(s2d_shapes, ("abn",))
    errs = {"channel_sums": 0.0, "abn_norm_act": 0.0, "abn_bwd": 0.0}
    for shape in unique:
        for pair in (False, True):
            a = cuda_input(shape, torch.bfloat16, "channels_last", g)
            b = cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0) if pair else None
            errs["channel_sums"] = max(errs["channel_sums"], _b1_case(a, b)[0])
            del a, b
        x = cuda_input(shape, torch.bfloat16, "channels_last", g)
        scale = torch.rand(shape[1], device="cuda", generator=g) + 0.5
        shift = torch.randn(shape[1], device="cuda", generator=g)
        for act in ("none", "leaky_relu"):
            errs["abn_norm_act"] = max(errs["abn_norm_act"], _check(x, scale, shift, act, (8e-3, 0.0)))
        del x
    for shape in abn_unique:
        z, grad, gamma, beta = _abn_output(shape, torch.bfloat16, "channels_last", "leaky_relu", g)
        errs["abn_bwd"] = max(errs["abn_bwd"], _b3_case(z, grad, gamma, beta, "leaky_relu")[0])
        del z, grad
    if not unique or not abn_unique:
        raise AssertionError(f"kernel_s2d: no s2d shape to check ({unique}, {abn_unique})")

    timed = {}

    def timing(shape):
        if shape in timed:
            return timed[shape]
        a = cuda_input(shape, torch.bfloat16, "channels_last", g)
        b = cuda_input(shape, torch.bfloat16, "channels_last", g, 0.0, 1.0)
        scale = torch.rand(shape[1], device="cuda", generator=g) + 0.5
        shift = torch.randn(shape[1], device="cuda", generator=g)
        n, c = a.numel(), shape[1]
        single_lib = b1_library_calls(a, None, "single")
        pair_lib = b1_library_calls(a, b, "pair")
        timed[shape] = dict(
            shape=list(shape),
            channel_sums=timing_entry(
                n * 2 + 2 * 4 * c, 3 * n, card, ms=cuda_ms(lambda: kernels.channel_sums_cuda(a)),
                plain_ms=cuda_ms(lambda: channel_sums_plain(a)),
                library_ms=cuda_ms(single_lib["var_mean"])),
            channel_sums_pair=timing_entry(
                2 * n * 2 + 2 * 4 * c, 3 * n, card,
                ms=cuda_ms(lambda: kernels.channel_sums_cuda(a, b)),
                plain_ms=cuda_ms(lambda: channel_sums_plain(a, b)),
                library_ms=cuda_ms(pair_lib["batch_norm_backward_reduce"])),
            abn_norm_act=timing_entry(
                2 * n * 2 + 2 * 4 * c, 3 * n, card,
                ms=cuda_ms(lambda: kernels.abn_norm_act_cuda(a, scale, shift, "none", SLOPE)),
                plain_ms=cuda_ms(lambda: abn_norm_act_plain(a, scale, shift, "none", SLOPE)),
                library_ms=cuda_ms(batch_norm_affine(a, scale, shift))))
        return timed[shape]

    def s2d_level(model, kinds):
        # the calls of the s2d form's step that its normal form's lacks
        extra = (Counter(s for k in kinds for s in s2d_shapes[model][k])
                 - Counter(s for k in kinds for s in normal_shapes[model][k]))
        return list(extra)

    largest = {m: timing(_largest(s2d_level(m, ("bn", "abn")))) for m in s2d_shapes}
    big_abn = _largest(s2d_level("unet_abn", ("abn",)))
    z, grad, gamma, beta = _abn_output(big_abn, torch.bfloat16, "channels_last", "leaky_relu", g)
    n, c = z.numel(), big_abn[1]
    b3 = dict(shape=list(big_abn), activation="leaky_relu", **timing_entry(
        2 * n * 2 + 4 * 4 * c, 8 * n, card,
        ms=cuda_ms(lambda: kernels.abn_bwd_sums_cuda(z, grad, gamma, beta, "leaky_relu", SLOPE)),
        plain_ms=cuda_ms(lambda: abn_bwd_sums_plain(z, grad, gamma, beta, "leaky_relu", SLOPE)),
        library_ms=None))
    del z, grad
    emit("kernel_s2d", card=card, new_shapes=[list(s) for s in unique],
         new_abn_shapes=[list(s) for s in abn_unique], max_abs_err=errs,
         tolerance={"channel_sums": f"per channel |err| <= {RTOL_SUM} * sum|term| + 1e-6",
                    "abn_norm_act": "rtol 8e-3 (one bf16 ulp)",
                    "abn_bwd": f"per channel |err| <= {RTOL_SUM} * sum|term| + 1e-6"},
         largest_s2d_level_by_model=largest, abn_bwd_largest=b3,
         timing="device time, warm medians of 20; library: torch.var_mean (single), "
                "torch.batch_norm_backward_reduce (pair), F.batch_norm over mean 0, var 1 "
                "(B2's activation-none form)")
    return {"channel_sums": dict(max_abs_err=errs["channel_sums"], new_shapes=len(unique),
                                 largest_by_model={m: dict(single=r["channel_sums"],
                                                           pair=r["channel_sums_pair"],
                                                           shape=r["shape"])
                                                   for m, r in largest.items()}),
            "abn_norm_act": dict(max_abs_err=errs["abn_norm_act"], new_shapes=len(unique),
                                 largest_by_model={m: dict(r["abn_norm_act"], shape=r["shape"])
                                                   for m, r in largest.items()}),
            "abn_bwd": dict(max_abs_err=errs["abn_bwd"], shapes=len(abn_unique), largest=b3)}


def phase_s2d_parity():
    """One fp32 SGD step (dropout off, TF32 off) of full-width ZF_UNET (bce)
    and UNetABN (bce_jaccard) in s2d form on 2x3x128x128 SHAPES: the card
    against the CPU and float64 by PARITY_TOL, launches the layer count; and
    the card's s2d step against its own normal-space step by the same loss
    and gradient gates and the running-statistics tolerance."""
    xs, ys = to_nchw([ShapesDataset(2, 128, seed=SEED + 34)[i] for i in range(2)])
    t, out, ok = PARITY_TOL, {}, True
    for name, loss_name in (("zf_unet", "bce"), ("unet_abn", "bce_jaccard")):
        runs = parity_runs(name, loss_name, xs, ys,
                           STEP_VARIANTS + (("card_normal", "cuda", torch.float32),),
                           attrs=dict(s2d=True))
        fields, step_ok = parity_verdict(runs, MODEL_STEP_LAUNCHES[name])
        (loss_s, grads_s, state_s, _), (loss_n, grads_n, state_n, launches_n) = (
            runs["card"], runs["card_normal"])
        versus = _grad_summary(_grad_errors(grads_s, grads_n))
        stats_ok, stats_err = True, 0.0
        for k, v in state_n.items():
            if k.endswith(("running_mean", "running_var")):
                err = (state_s[k] - v).abs()
                stats_err = max(stats_err, float(err.max()))
                stats_ok &= bool((err <= t["stats_atol"] + t["stats_rtol"] * v.abs()).all())
        normal_ok = (abs(loss_s - loss_n) <= t["loss_rtol"] * abs(loss_n) and stats_ok
                     and versus["median"] <= t["grad_median"] and versus["max"] <= t["grad_max"]
                     and launches_n == MODEL_STEP_LAUNCHES[name])
        out[name] = dict(fields, s2d_vs_normal_on_card=dict(
            loss_normal=loss_n, grad_err=versus, max_running_stat_err=stats_err,
            normal_launches=launches_n, ok=bool(normal_ok)), step_ok=step_ok)
        ok &= step_ok and normal_ok
    emit("s2d_parity", step_input=[2, 3, 128, 128], lr=PARITY_LR, models=out, ok=bool(ok))
    if not ok:
        raise AssertionError("s2d_parity failed")


def _summary(runs):
    return dict(ms_per_step=[r["ms_per_step"] for r in runs],
                images_per_s=[r["images_per_s"] for r in runs],
                peak_gb=[r["max_memory_allocated"] / 1e9 for r in runs],
                first_loss=runs[0]["first_loss"], last_loss=runs[0]["last_loss"],
                launches_per_step=runs[0]["launches_per_step"])


def phase_train_s2d(smi: str):
    """segtpu's s2d bench form of zf_unet-512 and unet11-finetune-512, and
    UNetABN (B3 on grouped statistics), at batch 16, patch 512, bf16, lr
    1e-3: in turns normal, s2d, s2d, normal, each 3 warm and S2D_STEPS timed
    steps; ms/step, images/s and peak memory of each, launches per step the
    layer count in both forms, frozen encoders unchanged, the four runs'
    first losses within PARITY_TOL's loss_rtol of each other; the forward conv
    GFLOP per image of both forms (FlopCounterMode on the CPU). The launch
    counts of the s2d runs are returned."""
    rows, counts, ok = {}, Counter(), True
    for config, name, loss_name, optimizer, freeze in S2D_CONFIGS:
        runs = [train_run(name, loss_name, optimizer, TRAIN_WARMUP, S2D_STEPS,
                          freeze_encoder=freeze, attrs=dict(s2d=on))
                for on in (False, True, True, False)]
        for run in runs[1:3]:
            counts.update(run["launches"])
        normal, s2d_runs = _summary([runs[0], runs[3]]), _summary(runs[1:3])
        # the same first loss in both forms: the fp32 loss rule
        first_ok = all(abs(r["first_loss"] - runs[0]["first_loss"])
                       <= PARITY_TOL["loss_rtol"] * abs(runs[0]["first_loss"]) for r in runs)
        run_ok = first_ok and all(_run_ok(r, MODEL_STEP_LAUNCHES[name], decreasing=False)
                                  and r["frozen_unchanged"] == r["frozen_parameters"]
                                  for r in runs)
        rows[config] = dict(
            model=name, loss=loss_name, optimizer=optimizer, freeze_encoder=freeze,
            normal=normal, s2d=s2d_runs,
            s2d_over_normal_ms=float(np.mean(s2d_runs["ms_per_step"])
                                     / np.mean(normal["ms_per_step"])),
            first_losses=[r["first_loss"] for r in runs], first_loss_ok=bool(first_ok),
            first_loss_rtol=PARITY_TOL["loss_rtol"],
            conv_gflop_per_image={"normal": conv_gflop_per_image(name, dict(s2d=False)),
                                  "s2d": conv_gflop_per_image(name, dict(s2d=True))},
            ok=bool(run_ok))
        ok &= run_ok
        torch.cuda.empty_cache()
    emit("train_s2d", card=smi, batch=TRAIN_BATCH, patch=PATCH, dtype="bf16 autocast",
         order="normal, s2d, s2d, normal", warmup_steps=TRAIN_WARMUP, steps=S2D_STEPS,
         configs=rows, ok=bool(ok))
    if not ok:
        raise AssertionError("train_s2d checks failed")
    return dict(counts)


def phase_train_tiramisu_a18(smi: str):
    """tiramisu67-512-b4 (batch 4, patch 512, bf16, bce, SGD lr 1e-3) with
    segtpu's A18 options: concat, packed, remat_policy="conv_in", both, and
    concat again, each 2 warm and A18_STEPS timed steps: ms/step, images/s,
    peak memory; launches per step (120, 60, 0), under conv_in (175, 115,
    0); the BatchNorm inputs packed growth copies (55 per forward); running
    statistics updated once per step; every form's first loss within
    PARITY_TOL's loss_rtol of concat's. Returns the launch counts of the
    packed and conv_in paths."""
    rows, counts, ok = {}, {}, True
    for label, attrs in A18_VARIANTS:
        run = train_run("tiramisu67", "bce", "sgd", 2, A18_STEPS, batch=TIRAMISU_BATCH,
                        attrs=attrs)
        conv_in = "remat_policy" in attrs
        expected = CONV_IN_LAUNCHES if conv_in else MODEL_STEP_LAUNCHES["tiramisu67"]
        copies = PACKED_COPIES * (2 if conv_in else 1) * A18_STEPS if attrs.get("packed") else 0
        run_ok = (all(np.isfinite(run["losses"]))
                  and run["launches_per_step"] == {k: float(v) for k, v in expected.items()}
                  and run["dense_copies"] == copies
                  and run["num_batches_tracked"] == [2 + A18_STEPS])
        rows[label] = dict({k: run[k] for k in ("attrs", "ms_per_step", "images_per_s",
                                                "max_memory_allocated", "first_loss",
                                                "last_loss", "launches_per_step", "dense_copies",
                                                "num_batches_tracked")},
                           expected_launches_per_step=expected, expected_dense_copies=copies,
                           ok=bool(run_ok))
        ok &= run_ok
        if label == "packed":
            counts["train_tiramisu_packed"] = run["launches"]
        elif label == "conv_in":
            counts["train_tiramisu_conv_in"] = run["launches"]
        torch.cuda.empty_cache()
    # the same first loss in every form: the fp32 loss rule
    first = rows["concat"]["first_loss"]
    first_ok = all(abs(r["first_loss"] - first) <= PARITY_TOL["loss_rtol"] * abs(first)
                   for r in rows.values())
    ok &= first_ok
    emit("train_tiramisu_a18", card=smi, config="tiramisu67-512-b4", steps=A18_STEPS,
         variants=rows, first_loss_ok=bool(first_ok), first_loss_rtol=PARITY_TOL["loss_rtol"],
         ok=bool(ok))
    if not ok:
        raise AssertionError("train_tiramisu_a18 checks failed")
    return counts


def phase_serve_host_slice(state_dict, smi: str):
    """One seeded 5000x5000 image served as the submit CLI serves it
    (LinkNet34, patch 512, batch 64, D4 TTA, pyramid weights, bf16) with the
    tiles cut on the host (``slice_on_device=False``: native tile I/O, each
    chunk's tiles uploaded) and on the device, in turns device, host, host,
    device: probabilities within 1e-6, s/image of each, B2's launches of the
    host path (the counts set to 0 just before its second run); the native
    split's and NumPy's seconds for the image's 361 tiles. Then LinkNet34's
    s2d form (its head's 3x3 conv at 513^2) on a 1024^2 crop: fp32 (TF32 off)
    probabilities within 1e-4 of normal space's, and the bf16 masks'
    agreement. Returns the host path's launches."""
    model = seeded_model("cuda", state_dict)
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    image = np.random.default_rng(SEED + 95).integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3),
                                                      dtype=np.uint8)
    fn = make_predict_step(model, bf16=True)
    kw = dict(test_transform=transform, patch_size=PATCH, batch_size=BATCH, tta=True,
              weight="pyramid", device="cuda")
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    seconds, probs, launches = {"device": [], "host": []}, {}, None
    native.extract_tiles.calls = 0
    for label in ("device", "host", "host", "device"):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        probs[label] = predict_tiled(image, fn, slice_on_device=label == "device", **kw)
        seconds[label].append(time.perf_counter() - t0)
        if label == "host":
            launches = kernels.launch_counts()
    native_calls = native.extract_tiles.calls
    prob_diff = float(np.abs(probs["host"] - probs["device"]).max())
    slicer = ImageSlicer(image.shape, PATCH, PATCH // 2)
    n_tiles = len(slicer.crops)
    t0 = time.perf_counter()
    tiles = slicer.split_batch(image)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    same = np.array_equal(np.stack(slicer.split(image)), tiles)
    numpy_s = time.perf_counter() - t0
    del tiles

    crop = image[:1024, :1024]
    got = {}
    for s2d_on in (False, True):
        model.s2d = s2d_on
        with fp32_convolutions():
            p32 = predict_tiled(crop, make_predict_step(model), **kw)
        got[s2d_on] = (p32, predict_tiled(crop, make_predict_step(model, bf16=True), **kw))
    model.s2d = False
    s2d_fp32_diff = float(np.abs(got[True][0] - got[False][0]).max())
    s2d_bf16_agree = float(((got[True][1] > 0.5) == (got[False][1] > 0.5)).mean())
    passes = -(-n_tiles // (BATCH // 8))
    ok = (prob_diff <= 1e-6 and same and np.isfinite(probs["host"]).all() and native_calls == 2
          and launches["abn_norm_act"] == passes * 12 and s2d_fp32_diff <= 1e-4
          and s2d_bf16_agree >= 0.99)
    emit("serve_host_slice", card=smi, image=[IMAGE_SIDE, IMAGE_SIDE, 3], patch=PATCH,
         batch=BATCH, tta=8, dtype="bfloat16", order="device, host, host, device",
         s_per_image=seconds, host_vs_device_max_prob_diff=prob_diff, tolerance="atol 1e-6",
         launches=launches, expected_abn_norm_act=passes * 12, native_build_s=build_s,
         native_extract_calls=native_calls,
         split_tiles=n_tiles, native_split_s=native_s, numpy_split_s=numpy_s,
         native_split_equals_numpy=same, s2d_crop=[1024, 1024],
         s2d_vs_normal_fp32_max_prob_diff=s2d_fp32_diff, s2d_fp32_tolerance="atol 1e-4",
         s2d_vs_normal_bf16_mask_agreement=s2d_bf16_agree, ok=bool(ok))
    if not ok:
        raise AssertionError("serve_host_slice checks failed")
    return launches


# ---------------------------------------------------------------------------
# The parallel modes: two ranks on the one card
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one device, gloo takes CUDA tensors: the ranks of
# train_dp, train_tp and serve_tile_parallel are two processes on cuda:0
# over gloo. They measure correctness and overhead, not scaling.
PAR_RANKS, PAR_WARMUP, PAR_STEPS = 2, 3, 5
PAR_TIMEOUT_S = 300


def _par_batch():
    """Config #2's global batch (16 x 3 x 512^2 SHAPES) on the card, the same
    in every process."""
    return DeviceShapes(PATCH, device="cuda").batch(
        TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(SEED + 50))


def par_model(grid):
    """The seeded LinkNet34 on the card for ``grid``: rank 0's weights, sync
    BatchNorm over the data group, the dropouts' rows of the global batch,
    the model group's shards. Returns ``(model, sharded keys)``."""
    model = seeded_model("cuda")
    if grid.world > 1:
        replicate(model)
    set_process_group(model, grid.data_group)
    set_data_shard(model, grid.data_rank, grid.data_size)
    return model, tensor_parallel.shard_model(model, grid)


def par_compare_step(grid):
    """One fp32 (TF32 off) Adam step (lr PARITY_LR, dropout on) on the
    global batch: the loss, the full gradients and state on the CPU, this
    rank's launches and parameter count."""
    with fp32_convolutions():
        model, sharded = par_model(grid)
        opt = get_optimizer("adam", model.parameters(), PARITY_LR)
        step = make_train_step(model, opt, get_loss("bce_jaccard"), default_metrics(), grid=grid)
        x, y = shard_batch(_par_batch(), grid)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logs = step(x, y, PARITY_LR)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        grads = {n: tensor_parallel.gather_shard(p.grad, sharded[n], grid.model_group)
                 if n in sharded else p.grad for n, p in model.named_parameters()}
        state = (tensor_parallel.full_state_dict(model, sharded, grid) if sharded
                 else model.state_dict())
    return dict(loss=float(logs["loss"]), launches=launches, sharded=len(sharded),
                local_params=sum(p.numel() for p in model.parameters()),
                grads={n: g.detach().cpu().double() for n, g in grads.items()},
                state={k: v.detach().cpu() for k, v in state.items()})


def par_time_steps(grid):
    """Config #2 (bf16 autocast, Adam 1e-3) on this rank's slice of the
    global batch: PAR_WARMUP then PAR_STEPS timed steps, launches counted
    over the timed ones."""
    model, _ = par_model(grid)
    step = make_train_step(model, get_optimizer("adam", model.parameters(), TRAIN_LR),
                           get_loss("bce_jaccard"), default_metrics(), bf16=True, grid=grid)
    x, y = shard_batch(_par_batch(), grid)
    for _ in range(PAR_WARMUP):
        step(x, y, TRAIN_LR)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(x, y, TRAIN_LR)["loss"] for _ in range(PAR_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(ms_per_step=seconds * 1e3 / PAR_STEPS, launches=kernels.launch_counts(),
                losses=[float(v) for v in losses], local_batch=int(x.shape[0]))


def _serve_image():
    return np.random.default_rng(SEED + 60).integers(0, 256, (IMAGE_SIDE, IMAGE_SIDE, 3),
                                                     dtype=np.uint8)


def _serve_kw(grid):
    transform = aug.Sequential([aug.ImageOnly(aug.NormalizeImage(mean=INRIA_MEAN, std=INRIA_STD))])
    return dict(test_transform=transform, patch_size=PATCH, batch_size=BATCH, tta=True,
                weight="pyramid", device="cuda", grid=grid)


def par_tile(grid, state_dict):
    """Tile-parallel serving of the seeded 5000^2 image: fp32 (TF32 off)
    probabilities, then one warm and one timed bf16 pass (config #5) with
    its launches."""
    model = seeded_model("cuda", state_dict)
    image = _serve_image()
    with fp32_convolutions():
        probs = predict_tiled(image, make_predict_step(model), **_serve_kw(grid))
    bf16_fn = make_predict_step(model, bf16=True)
    predict_tiled(image, bf16_fn, threshold=0.5, **_serve_kw(grid))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mask = predict_tiled(image, bf16_fn, threshold=0.5, **_serve_kw(grid))
    seconds = time.perf_counter() - t0
    return dict(probs=probs if grid.is_main else None, s_per_image=seconds,
                launches=kernels.launch_counts(), mask_mean=float(mask.mean()))


def rank_worker(cases_file: str, out_dir: str) -> None:
    """One rank of the parallel phases, run as ``chip_smoke.py --rank-worker
    CASES OUT`` with the launcher variables set: data parallel (compare,
    time), tile-parallel serving, then tensor parallel (compare)."""
    assert maybe_initialize_distributed("cuda", backend="gloo")
    cases = torch.load(cases_file, weights_only=False)
    grid = make_grid(1)
    out = dict(dp_compare=par_compare_step(grid), dp_time=par_time_steps(grid))
    out["tile"] = par_tile(grid, cases["state_dict"])
    out["tp_compare"] = par_compare_step(make_grid(2))
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_rank_workers(tmpdir: Path, state_dict) -> list:
    """Start PAR_RANKS ranks of :func:`rank_worker` on cuda:0 over gloo and
    wait for them; fails with a rank's output tail when one fails."""
    cases = tmpdir / "cases.pt"
    torch.save(dict(state_dict=state_dict), cases)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(PAR_RANKS), LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker",
                               str(cases), str(tmpdir)], env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(PAR_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {r} exited {p.returncode}:\n{out[-6000:]}")
    return [torch.load(tmpdir / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]


def par_verdict(got, one):
    """A rank's fp32 step against the one process's by PARITY_TOL: loss,
    gradient errors (median, max), running statistics, and each updated
    parameter within Adam's :func:`update_bound`."""
    t = PARITY_TOL
    errs = _grad_errors(got["grads"], one["grads"])
    floor = t["grad_floor"] * max(float(w.abs().max()) for w in one["grads"].values())
    stats_err, params_ratio = 0.0, 0.0
    for k, v in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            stats_err = max(stats_err, float((got["state"][k] - v).abs().max()))
        elif k in one["grads"]:
            g = one["grads"][k]
            gate = update_bound("adam", g, t["grad_max"] * max(float(g.abs().max()), floor))
            err = (got["state"][k].double() - v.double()).abs()
            params_ratio = max(params_ratio, float((err / (gate + t["params_atol"])).max()))
    summary = _grad_summary(errs)
    ok = (abs(got["loss"] - one["loss"]) <= t["loss_rtol"] * abs(one["loss"])
          and summary["median"] <= t["grad_median"] and summary["max"] <= t["grad_max"]
          and stats_err <= t["stats_atol"] and params_ratio <= 1.0
          and got["launches"] == STEP_LAUNCHES)
    return dict(loss=got["loss"], loss_one_process=one["loss"], grad_err=summary,
                max_running_stat_err=stats_err, param_err_over_gate=params_ratio,
                launches=got["launches"], local_params=got["local_params"],
                sharded_tensors=got["sharded"]), bool(ok)


def _summed(launches) -> dict:
    """The ranks' launch counts added, kernel by kernel (zeros kept)."""
    launches = list(launches)
    return {k: sum(c[k] for c in launches) for k in launches[0]}


def phase_parallel(smi: str, state_dict, tmpdir: Path):
    """train_dp (a), train_tp and serve_tile_parallel: the one process's
    references here, then PAR_RANKS ranks on the card (module docstring)."""
    one = par_compare_step(Grid())
    model = seeded_model("cuda", state_dict)
    with fp32_convolutions():
        probs_one = predict_tiled(_serve_image(), make_predict_step(model), **_serve_kw(None))
    del model
    torch.cuda.empty_cache()
    ranks = run_rank_workers(tmpdir, state_dict)
    counts = {}

    dp = [par_verdict(r["dp_compare"], one) for r in ranks]
    timed = [r["dp_time"] for r in ranks]
    per_rank = {k: v * PAR_STEPS for k, v in STEP_LAUNCHES.items()}
    ok = all(o for _, o in dp) and all(t["launches"] == per_rank and np.isfinite(t["losses"]).all()
                                      for t in timed)
    counts["train_dp"] = _summed(t["launches"] for t in timed)
    emit("train_dp", ranks=PAR_RANKS, backend="gloo", device="cuda:0 (both ranks)",
         global_batch=TRAIN_BATCH, compare=[f for f, _ in dp], one_process_loss=one["loss"],
         timed=[{k: v for k, v in t.items()} for t in timed], expected_launches_per_rank=per_rank,
         ms_per_step_per_rank=[t["ms_per_step"] for t in timed], card=smi, tolerance=PARITY_TOL,
         ok=ok)
    if not ok:
        raise AssertionError("train_dp checks failed")

    tp = [par_verdict(r["tp_compare"], one) for r in ranks]
    full = sum(p.numel() for p in seeded_model("cpu").parameters())
    ok = all(o for _, o in tp) and all(f["local_params"] < 0.6 * full and f["sharded_tensors"] > 100
                                      for f, _ in tp)
    counts["train_tp"] = _summed(r["tp_compare"]["launches"] for r in ranks)
    emit("train_tp", ranks=PAR_RANKS, model_parallel=PAR_RANKS, backend="gloo",
         compare=[f for f, _ in tp], full_params=full, tolerance=PARITY_TOL, ok=ok)
    if not ok:
        raise AssertionError("train_tp checks failed")

    tiles = [r["tile"] for r in ranks]
    err = float(np.abs(tiles[0]["probs"] - probs_one).max())
    passes = -(-len(ImageSlicer((IMAGE_SIDE, IMAGE_SIDE), PATCH, PATCH // 2).crops) // (BATCH // 8))
    expected = {k: v * passes for k, v in EVAL_LAUNCHES.items()}
    ok = err <= 1e-4 and all(t["launches"] == expected for t in tiles)
    counts["serve_tile_parallel"] = _summed(t["launches"] for t in tiles)
    emit("serve_tile_parallel", ranks=PAR_RANKS, image=IMAGE_SIDE, patch=PATCH, batch=BATCH,
         tta=True, max_prob_err_fp32=err, atol=1e-4,
         s_per_image_bf16=[t["s_per_image"] for t in tiles], launches=[t["launches"] for t in tiles],
         expected_launches_per_rank=expected, card=smi, ok=ok)
    if not ok:
        raise AssertionError("serve_tile_parallel checks failed")
    return counts


def phase_train_dp_cli(step_ms: float, tmpdir: Path):
    """train_dp (b): one rank through the train CLI's own NCCL start, the
    launcher variables set (world 1), 4 shapes-device steps."""
    launch = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=str(_free_port()))
    saved = {k: os.environ.get(k) for k in launch}
    os.environ.update(launch)
    backends = []
    try:
        _, out = cli_run("dp_nccl", CLI_ARGS + ["-d", "shapes-device", "-s", "4", "-e", "1",
                                                "--experiments-dir", str(tmpdir / "dp")],
                         4, 1, step_ms, main=lambda argv: train_cli.main(
                             argv, model_initializer=lambda m, a: backends.append(
                                 dist.get_backend())))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ok = backends == ["nccl"] and not dist.is_initialized()
    emit("train_dp_cli", run=out, backend=backends, ok=ok)
    if not ok:
        raise AssertionError("train_dp_cli checks failed")
    return out["launches"]


def _torchvision_resnet34(path: Path, seed: int) -> None:
    """A random torchvision-format ResNet-34 file with its ``fc`` head."""
    g = torch.Generator().manual_seed(seed)
    enc = resnet34()
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(("running_mean", "bn1.bias", "bn2.bias")):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = v
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    torch.save({"state_dict": sd}, path)


def phase_serve_ckpt(state_dict, tmpdir: Path):
    """LinkNet34 with random torchvision-format encoder weights, written as
    segtpu's ``.ckpt`` directory and as a ``.pth``: the card's model loaded
    the submit CLI's way (``--encoder-weights``, then ``-c <dir>.ckpt``)
    against the CPU's from the ``.pth`` (fp32 logits, atol 1e-3); then
    ``submit_cli -c <dir>.ckpt --encoder-weights`` serves one 1024^2 image
    (bf16, batch 64, TTA), its B2 launches counted."""
    import cv2

    enc = tmpdir / "resnet34.pth"
    _torchvision_resnet34(enc, SEED + 70)
    cpu_model = seeded_model("cpu", state_dict)
    install_encoder_weights("linknet34", cpu_model, str(enc))
    save_snapshot(str(tmpdir / "w.pth"), cpu_model, epoch=0, loss=0.0)
    ckpt = tmpdir / "linknet34_checkpoint.ckpt"
    save_flax_snapshot(str(ckpt), "linknet34", cpu_model.state_dict(), epoch=0, loss=0.0,
                       train_history={})
    card_model = get_model("linknet34", patch_size=PATCH, device="cuda")
    install_encoder_weights("linknet34", card_model, str(enc))
    submit_cli.load_checkpoint(card_model, "linknet34", str(ckpt))
    pth_model = get_model("linknet34", patch_size=PATCH, device="cpu")
    pth_model.load_state_dict(load_snapshot(str(tmpdir / "w.pth"))[0])
    x = torch.from_numpy(np.random.default_rng(SEED + 71).standard_normal((2, 3, PATCH, PATCH),
                                                                           np.float32) * 0.5)
    card_model.eval()
    pth_model.eval()
    with fp32_convolutions(), torch.inference_mode():
        got = card_model(x.cuda().contiguous(memory_format=torch.channels_last)).cpu()
        want = pth_model(x)
    logit_err = float((got - want).abs().max())

    side = 1024
    (tmpdir / "data" / "images").mkdir(parents=True)
    image = np.random.default_rng(SEED + 72).integers(0, 256, (side, side, 3), dtype=np.uint8)
    cv2.imwrite(str(tmpdir / "data" / "images" / "img.png"), image)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    submit_cli.main(["-m", "linknet34", "-c", str(ckpt), "--encoder-weights", str(enc),
                     "-p", str(PATCH), "-b", str(BATCH), "-dd", str(tmpdir / "data"), "--bf16",
                     "--submits-dir", str(tmpdir / "out")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    mask = cv2.imread(str(tmpdir / "out" / f"inria_linknet34_{PATCH}_rgb" / "img.tif"),
                      cv2.IMREAD_UNCHANGED)
    passes = -(-len(ImageSlicer((side, side), PATCH, PATCH // 2).crops) // (BATCH // 8))
    expected = {k: v * passes for k, v in EVAL_LAUNCHES.items()}
    ok = (logit_err <= 1e-3 and np.isfinite(got).all().item() and mask is not None
          and mask.shape == (side, side) and launches == expected)
    emit("serve_ckpt", logit_err_card_vs_cpu_pth=logit_err, atol=1e-3, ckpt_files=sorted(
        f.name for f in ckpt.iterdir()), submit_s=seconds, launches=launches,
         expected_launches=expected, mask_shape=None if mask is None else list(mask.shape), ok=ok)
    if not ok:
        raise AssertionError("serve_ckpt checks failed")
    return launches


# The harness phases: bench_all's training depth and #5's images and
# repeats; #5's s/image against serve's
BENCH_ALL_STEPS = dict(warmup=3, steps=5)
BENCH_ALL_TILED = dict(n_images=1, repeats=1)
SERVE_TOL = 0.10
# roofline's runs (config, normal space) and timed steps
ROOFLINE_RUNS = (("linknet34-bce_jaccard-adam-512", False), ("zf_unet-512", False),
                 ("zf_unet-512", True))
ROOFLINE_STEPS = 10
# ladder_l0's train steps per leg (its epoch, cut from the fixture's 55)
LADDER_STEPS = 16


def _times(per_step, n):
    return {k: v * n for k, v in per_step.items()}


def phase_ladder_l0(tmpdir: Path):
    """Two 1-epoch L0 legs of the ladder (LADDER_STEPS train steps): the
    same CSV bit for bit, kernels launched, the switches and precision
    flags restored."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.deterministic)
    patched = lambda: (ab_ladder.dsb2018._heavy_geometric, train_cli.DataLoader,  # noqa: E731
                       train_cli.get_model, abn_ops._on_device)
    before, before_flags = patched(), flags()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    result = ab_ladder.Ladder(tmpdir / "work", tmpdir / "out", epochs=1,
                              steps=LADDER_STEPS).l0()
    launches = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    restored = patched() == before and flags() == before_flags
    history = ab_ladder.read_csv(result["csv"])
    ok = (result["same_bits"] and restored and all(launches.values())
          and all(np.isfinite(v) for col in history.values() for v in col))
    emit("ladder_l0", epochs=1, same_bits=result["same_bits"], restored=restored,
         history=history, launches=launches, seconds=seconds, ok=bool(ok))
    if not ok:
        raise AssertionError("ladder_l0 checks failed")
    return launches


def phase_bench_all(smi: str, serve_s: float):
    """bench --all through run_config at a cut depth: six JSON lines, each
    config's launches, and #5's s/image against serve's."""
    rows, counts, ok = [], Counter(), True
    passes = -(-19 * 19 // (BATCH // 8))
    for name in bench.CONFIG_NAMES:
        tiled = name == bench.TILED_CONFIG
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        line = bench.run_config(name, device="cuda",
                                **(BENCH_ALL_TILED if tiled else BENCH_ALL_STEPS))
        launches = kernels.launch_counts()
        if tiled:
            expected = dict(NO_LAUNCHES, abn_norm_act=(1 + BENCH_ALL_TILED["n_images"]) * passes
                            * EVAL_LAUNCHES["abn_norm_act"])
        else:
            expected = _times(MODEL_STEP_LAUNCHES[bench.BENCH_CONFIGS[name]["model_name"]],
                              BENCH_ALL_STEPS["warmup"] + BENCH_ALL_STEPS["steps"])
        line_ok = (launches == expected and np.isfinite(line["value"]) and line["value"] > 0
                   and line["device"] == torch.cuda.get_device_name(0))
        ok &= line_ok
        counts.update(launches)
        rows.append(dict(line, launches=launches, expected_launches=expected,
                         seconds=time.perf_counter() - t0, ok=bool(line_ok)))
        torch.cuda.empty_cache()
    tiled_s = next(r["value"] for r in rows if r["metric"].startswith(bench.TILED_CONFIG))
    rel = tiled_s / serve_s - 1
    ok &= len(rows) == 6 and abs(rel) <= SERVE_TOL
    emit("bench_all", card=smi, lines=rows, depth=dict(BENCH_ALL_STEPS, tiled=BENCH_ALL_TILED),
         serve_s_per_image=serve_s, tiled_over_serve_minus_1=rel, tolerance=SERVE_TOL,
         ok=bool(ok))
    if not ok:
        raise AssertionError("bench_all checks failed")
    return dict(counts)


def phase_roofline(smi: str):
    """roofline.analyze on the ROOFLINE_RUNS: mfu_pct in (0, 100], the same
    model GFLOP in both zf_unet forms, launches the layer count per step."""
    rows, counts, ok = [], Counter(), True
    for config, no_s2d in ROOFLINE_RUNS:
        kernels.reset_launch_counts()
        row = roofline.analyze(config, no_s2d=no_s2d, steps=ROOFLINE_STEPS, device="cuda")
        launches = kernels.launch_counts()
        expected = _times(MODEL_STEP_LAUNCHES[row["model"]], 2 + roofline.WARMUP + ROOFLINE_STEPS)
        row_ok = 0 < row["mfu_pct"] <= 100 and launches == expected
        ok &= row_ok
        counts.update(launches)
        rows.append(dict(row, launches=launches, expected_launches=expected, ok=bool(row_ok)))
        torch.cuda.empty_cache()
    zf = {r["form"]: r["gflop_per_step"] for r in rows if r["config"] == "zf_unet-512"}
    same = zf["s2d"] == zf["normal"]
    ok &= same
    emit("roofline", card=smi, rows=rows, zf_unet_gflop_same_in_both_forms=same, ok=bool(ok))
    if not ok:
        raise AssertionError("roofline checks failed")
    return dict(counts)


def phase_tiled_floor(smi: str, serve_s: float):
    """Config #5's floor on the card; it must not exceed serve's s/image."""
    kernels.reset_launch_counts()
    row = tiled_floor.analyze(device="cuda", measured_s_per_image=serve_s)
    launches = kernels.launch_counts()
    ok = (row["tiles"] == 361 and row["passes_needed"] == 2888
          and 0 < row["floor_s_per_image"] <= serve_s and launches == EVAL_LAUNCHES)
    emit("tiled_floor", **row, launches=launches, ok=bool(ok))
    if not ok:
        raise AssertionError("tiled_floor checks failed")
    return launches


def phase_bn_sol(smi: str):
    """bn_sol on config #2: 48 sites, a B1/B3 time inside the step, a bound
    below the step."""
    kernels.reset_launch_counts()
    row = bn_sol.analyze("linknet34-bce_jaccard-adam-512")
    launches = kernels.launch_counts()
    ok = (row["sites"] == sum(NORM_LAYERS["linknet34"]) and 0 < row["reduce_ms"] < row["step_ms"]
          and row["sol_reduce_ms"] < row["reduce_ms"] and row["step_bound_ms"] < row["step_ms"]
          and all(launches.values()))
    emit("bn_sol", **row, launches=launches, ok=bool(ok))
    if not ok:
        raise AssertionError("bn_sol checks failed")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of segtpu_torch on one GPU")
    parser.add_argument("--ab-out", default=None,
                        help="Write train_nuclei's comparison.md and the port's CSVs here")
    parser.add_argument("--rank-worker", nargs=2, metavar=("CASES", "OUT"), default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_worker is not None:
        rank_worker(*args.rank_worker)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    card, smi = phase_device()
    phase_build()
    norm_shapes = {m: step_norm_shapes(b, PATCH, model_name=m) for m, b in KERNEL_MODELS.items()}
    nuclei_shapes = {m: step_norm_shapes(ab_nuclei.BATCH, ab_nuclei.PATCH, model_name=m)
                     for m in NUCLEI_LAUNCHES}
    zoo_shapes = {m: step_norm_shapes(b, PATCH, model_name=m) for m, b in ZOO_BATCH.items()
                  if NORM_LAYERS[m][0]}
    fp32_shapes = dict(nuclei_shapes, **{
        f"{m} parity": step_norm_shapes(2, 64, model_name=m) for m in zoo_shapes})
    s2d_shapes = s2d_step_shapes()
    torch.cuda.empty_cache()
    b1, b1_err = phase_kernel_b1(card, norm_shapes, fp32_shapes, zoo_shapes)
    b3, b3_err = phase_kernel_b3(card, norm_shapes, nuclei_shapes)
    b2, b2_err = phase_kernel_b2(card, norm_shapes, fp32_shapes, zoo_shapes)
    torch.cuda.empty_cache()
    s2d_kernels = phase_kernel_s2d(card, s2d_shapes, dict(norm_shapes, **zoo_shapes),
                                   set(_unique(norm_shapes, ("bn", "abn")))
                                   | set(_unique(zoo_shapes, ("bn",))))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        state_dict = phase_model_parity(Path(tmp))
    counts = {}
    counts["serve"], serve_s = phase_serve(state_dict)
    phase_train_parity()
    counts["train"], step_ms = phase_train()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts.update(phase_parallel(smi, state_dict, Path(tmp)))
    with tempfile.TemporaryDirectory() as tmp:
        counts["train_dp_cli"] = phase_train_dp_cli(step_ms, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        counts["serve_ckpt"] = phase_serve_ckpt(state_dict, Path(tmp))
    counts["serve_host_slice"] = phase_serve_host_slice(state_dict, smi)
    torch.cuda.empty_cache()
    phase_zf_unet_parity()
    counts["train_zf_unet"] = phase_train_zf_unet(smi)
    counts["train_unet_abn"] = phase_train_unet_abn(smi)
    torch.cuda.empty_cache()
    phase_tiramisu_parity()
    counts["train_tiramisu67"] = phase_train_tiramisu67(smi)
    torch.cuda.empty_cache()
    phase_albunet_parity()
    counts["train_albunet"], albunet_ms = phase_train_albunet(smi)
    counts["train_unet11"] = phase_train_unet11(smi)
    torch.cuda.empty_cache()
    phase_s2d_parity()
    counts["train_s2d"] = phase_train_s2d(smi)
    counts.update(phase_train_tiramisu_a18(smi))
    torch.cuda.empty_cache()
    phase_zoo_parity()
    counts["train_zoo"] = phase_train_zoo(smi)
    with tempfile.TemporaryDirectory() as tmp:
        counts["train_cli_psp_net"] = phase_train_cli_psp_net(Path(tmp))
    counts["serve_zoo"] = phase_serve_zoo(smi)
    torch.cuda.empty_cache()
    counts["wider_resnet"] = phase_wider_resnet()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts["train_cli"] = phase_train_cli(step_ms, Path(tmp))
        counts["train_ab_cli"] = phase_train_ab_cli(step_ms, Path(tmp))
        counts["train_cli_albunet"] = phase_train_cli_albunet(albunet_ms, Path(tmp))
    torch.cuda.empty_cache()
    phase_augment_parity(step_ms)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts["train_cli_device_augs"] = phase_train_cli_device_augs(step_ms, Path(tmp))
        phase_lr_finder(Path(tmp))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        counts["train_nuclei"] = phase_train_nuclei(card, Path(tmp), args.ab_out)
        counts["train_nuclei_device_augs"] = phase_nuclei_device_augs(
            Path(tmp) / "ab_nuclei" / "data" / "dsb2018", Path(tmp) / "nuclei_device_augs")
    with tempfile.TemporaryDirectory() as tmp:
        counts["ladder_l0"] = phase_ladder_l0(Path(tmp))
    torch.cuda.empty_cache()
    counts["bench_all"] = phase_bench_all(smi, serve_s)
    torch.cuda.empty_cache()
    counts["roofline"] = phase_roofline(smi)
    counts["tiled_floor"] = phase_tiled_floor(smi, serve_s)
    torch.cuda.empty_cache()
    counts["bn_sol"] = phase_bn_sol(smi)
    torch.cuda.empty_cache()
    counters = kernels.counter_buffers()
    if not counters or any(int(buf.count_nonzero()) for buf in counters):
        raise AssertionError("the B1/B3 counter buffers are not all zero after training: "
                             f"{[int(buf.count_nonzero()) for buf in counters]}")
    emit("counters", buffers=len(counters), ints=sum(buf.numel() for buf in counters),
         nonzero=0, ok=True)
    phase_one_launch(norm_shapes)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_profile(Path(tmp))
    by_path = {name: {p: counts[p][name] for p in PATHS} for name in KERNEL_PATHS}
    for name, paths in KERNEL_PATHS.items():
        for path in paths:
            if by_path[name][path] == 0:
                raise AssertionError(f"the {path} path never launched the {name} kernel")
    print(json.dumps({"kernels": [
        kernel_entry("B1", "channel_sums", "segtpu/ops/bn_alt.py:100",
                     sum(by_path["channel_sums"].values()), b1_err, b1,
                     form="single (sum x, sum x^2); library: torch.var_mean (single), "
                          "torch.batch_norm_backward_reduce (pair)",
                     pair=b1["pair"], largest_by_model=b1["largest_by_model"],
                     zoo_largest_by_model=b1["zoo_largest_by_model"],
                     scalar_loads={k: v for k, v in b1["scalar_loads"].items() if k != "per_shape"},
                     per_step=_per_step_entry(b1["per_step"]),
                     s2d=s2d_kernels["channel_sums"],
                     launches_by_path=by_path["channel_sums"]),
        kernel_entry("B2", "abn_norm_act", "segtpu/ops/bn_alt.py:181",
                     sum(by_path["abn_norm_act"].values()), b2_err, dict(b2, library_ms=None),
                     largest_training=b2["largest_training"],
                     largest_training_by_model=b2["largest_training_by_model"],
                     zoo_largest_by_model=b2["zoo_largest_by_model"],
                     batch_norm_affine=b2["batch_norm_affine"], c_sweep=b2["c_sweep"],
                     per_step=_per_step_entry(b2["per_step"]),
                     s2d=s2d_kernels["abn_norm_act"],
                     launches_by_path=by_path["abn_norm_act"]),
        kernel_entry("B3", "abn_bwd", "segtpu/ops/bn_alt.py:216", sum(by_path["abn_bwd"].values()),
                     b3_err, b3, activation="leaky_relu", largest_linknet34=b3["largest_linknet34"],
                     per_step=_per_step_entry(b3["per_step"]),
                     s2d=s2d_kernels["abn_bwd"],
                     launches_by_path=by_path["abn_bwd"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
