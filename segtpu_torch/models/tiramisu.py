"""FC-DenseNet "Tiramisu" 57/67/103 (counterpart of
segtpu/models/tiramisu.py:33-302; reference lib/models/tiramisu.py:93-205).

Dense blocks concatenate every layer's output, so each dense layer
normalises a concatenation whose width grows by the growth rate: on CUDA,
in training mode, each of its BatchNorms runs B1 forward and backward and
B2 for its affine (tiramisu67: 60 BatchNorms, so B1 120 and B2 60 launches
per step). ``remat=True`` runs each dense block through
:func:`layers.remat` in training, recomputing its activations in the
backward pass (segtpu's per-block ``nn.remat``); the running statistics are
updated once.

Attribute names are the reference's state_dict keys: ``firstconv``,
``denseBlocksDown.{i}.layers.{j}.norm/conv``, ``transDownBlocks.{i}.norm/conv``,
``bottleneck.bottleneck.layers.{j}``, ``transUpBlocks.{i}.convTrans``,
``denseBlocksUp.{i}.layers.{j}``, ``finalConv``.

Options of segtpu's FCDenseNet (segtpu tiramisu.py:33-180, :207-290), each
the same math and the same ``state_dict``:

* ``packed``: each dense block appends its layers' outputs to one buffer
  that it allocates once (:class:`_Prefix`) instead of concatenating anew
  per layer. A layer's input aliases the buffer's filled prefix, which no
  later write touches. A BatchNorm input must be dense for B1/B2, so each
  layer's BatchNorm copies its strided prefix (counted by
  ``ops.abn._dense.copies``).
* ``remat_policy="conv_in"``: per dense layer, the BatchNorm-ReLU chain
  runs under :func:`layers.remat`, so the backward keeps the conv's input
  and recomputes the normalisation (a BatchNorm's B1 and B2 run once more
  per step); exclusive with ``remat``, as in segtpu.
* ``s2d``: with even H and W, the first conv, the first dense block and its
  transition run in space-to-depth form. The block's running concat stays
  block-wise (each layer's new s2d channels appended as they come): its
  BatchNorms take ``stat_parts`` and its convs fold the order into the
  expanded kernel (``blocked_perm``). The transition's pool exits to normal
  space and the skip converts once (``d2s_parts``). This block keeps the
  concat under ``packed``, as segtpu's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import (BatchNormTorch, Conv, ConvTranspose2dTorch, Dropout2d,
                                        float_logits, max_pool, remat, s2d_conv)
from segtpu_torch.ops.s2d import blocked_perm, d2s_parts, s2d, s2d_max_pool_exit


class DenseLayer(nn.Module):
    """BN -> ReLU -> conv3x3 -> Dropout2d(0.2) (reference tiramisu.py:9-19):
    ``growth_rate`` new channels. ``conv_in``: the BN-ReLU chain runs under
    :func:`layers.remat` in training. ``in_parts``: the input is a
    block-wise concat of s2d tensors of these true channel counts, and the
    output is the s2d form of the new channels."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.norm = BatchNormTorch(in_channels)
        self.conv = Conv(in_channels, growth_rate, 3, padding=1)
        self.drop = Dropout2d(0.2)

    def _norm_relu(self, x: torch.Tensor, parts=None) -> torch.Tensor:
        return F.relu(self.norm(x, parts), inplace=True)

    def forward(self, x: torch.Tensor, conv_in: bool = False, in_parts=None) -> torch.Tensor:
        if conv_in and self.training and torch.is_grad_enabled():
            y = remat(self._norm_relu, x, in_parts)
        else:
            y = self._norm_relu(x, in_parts)
        if in_parts is None:
            return self.drop(self.conv(y))
        return self.drop(s2d_conv(self.conv, y, in_perm=blocked_perm(tuple(in_parts))), groups=4)


class _PrefixState:
    """A packed dense block's buffer and how many of its pieces are in it."""

    def __init__(self, buf: torch.Tensor):
        self.buf, self.written = buf, 0


class _Prefix(torch.autograd.Function):
    """``cat(pieces, 1)`` read from the packed block's buffer (segtpu's
    ``dynamic_update_slice`` growth): each piece is copied into the buffer
    once, by the first call that holds it, and the output aliases the
    buffer's first channels through a tensor of its own (``set_`` on the
    buffer's storage), so its version counter is not the buffer's: the
    later writes behind the prefix, which never touch its elements, do not
    trip autograd's check on the tensors that the layers saved. Backward:
    the gradient's channel slices, one per piece, as ``cat``'s."""

    @staticmethod
    def forward(ctx, state: _PrefixState, *pieces: torch.Tensor) -> torch.Tensor:
        buf, off, widths = state.buf, 0, []
        for i, piece in enumerate(pieces):
            if i >= state.written:
                buf[:, off:off + piece.shape[1]].copy_(piece)
            widths.append(piece.shape[1])
            off += piece.shape[1]
        state.written = len(pieces)
        ctx.widths = widths
        size = (buf.shape[0], off) + tuple(buf.shape[2:])
        return buf.new_empty(0).set_(buf.untyped_storage(), buf.storage_offset(), size,
                                     buf.stride())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        grads, off = [None], 0
        for w in ctx.widths:
            grads.append(g.narrow(1, off, w))
            off += w
        return tuple(grads)


class DenseBlock(nn.Module):
    """Concatenative growth (reference tiramisu.py:22-44): each layer reads
    the block's input and every earlier layer's output. Returns the input
    and all new features, or with ``upsample=True`` the new features only.
    ``packed``, ``conv_in``: module docstring; ``in_parts``: the s2d form
    (block-wise concat; not with ``upsample``)."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int, upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.growth_rate = growth_rate
        self.layers = nn.ModuleList(DenseLayer(in_channels + i * growth_rate, growth_rate)
                                    for i in range(n_layers))

    def forward(self, x: torch.Tensor, packed: bool = False, conv_in: bool = False,
                in_parts=None) -> torch.Tensor:
        if in_parts is not None:
            if self.upsample:
                raise ValueError("an upsampling dense block has no s2d form")
            parts = tuple(in_parts)
            for layer in self.layers:
                x = torch.cat([x, layer(x, conv_in, parts)], 1)
                parts += (self.growth_rate,)
            return x
        if packed:
            return self._packed(x, conv_in)
        new_features = []
        for layer in self.layers:
            out = layer(x, conv_in)
            x = torch.cat([x, out], 1)
            new_features.append(out)
        if self.upsample:
            return torch.cat(new_features, 1)
        return x

    def _packed(self, x: torch.Tensor, conv_in: bool) -> torch.Tensor:
        n_in = x.shape[1]
        total = n_in + len(self.layers) * self.growth_rate
        fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        state = _PrefixState(torch.empty((x.shape[0], total) + tuple(x.shape[2:]),
                                         dtype=x.dtype, device=x.device, memory_format=fmt))
        pieces = [x]
        for layer in self.layers:
            pieces.append(layer(_Prefix.apply(state, *pieces), conv_in).to(x.dtype))
        whole = _Prefix.apply(state, *pieces)
        return whole[:, n_in:] if self.upsample else whole


class TransitionDown(nn.Module):
    """BN -> ReLU -> conv1x1 -> Dropout2d(0.2) -> 2x2 max pool (reference
    tiramisu.py:47-59). ``in_parts``: a block-wise s2d input; the pool
    exits to normal space at half resolution."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = BatchNormTorch(in_channels)
        self.conv = Conv(in_channels, in_channels, 1)
        self.drop = Dropout2d(0.2)

    def forward(self, x: torch.Tensor, in_parts=None) -> torch.Tensor:
        if in_parts is None:
            return max_pool(self.drop(self.conv(F.relu(self.norm(x), inplace=True))))
        parts = tuple(in_parts)
        y = F.relu(self.norm(x, parts), inplace=True)
        y = self.drop(s2d_conv(self.conv, y, in_perm=blocked_perm(parts)), groups=4)
        return s2d_max_pool_exit(y)


def _center_crop(layer: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The central ``h`` x ``w`` window of an NCHW tensor, offsets floored
    (segtpu ``_center_crop``; reference tiramisu.py:86-90)."""
    y0, x0 = (layer.shape[2] - h) // 2, (layer.shape[3] - w) // 2
    return layer[:, :, y0:y0 + h, x0:x0 + w]


class TransitionUp(nn.Module):
    """ConvTranspose2d(k3, s2), center-cropped to the skip, then
    ``cat([up, skip], 1)`` (reference tiramisu.py:62-73)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.convTrans = ConvTranspose2dTorch(in_channels, out_channels, 3, 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = _center_crop(self.convTrans(x), skip.shape[2], skip.shape[3])
        return torch.cat([up, skip], 1)


class Bottleneck(nn.Module):
    """The reference's ``Bottleneck`` Sequential: one upsampling dense block
    under ``bottleneck``."""

    def __init__(self, in_channels: int, growth_rate: int, n_layers: int):
        super().__init__()
        self.bottleneck = DenseBlock(in_channels, growth_rate, n_layers, upsample=True)

    def forward(self, x: torch.Tensor, **options) -> torch.Tensor:
        return self.bottleneck(x, **options)


class FCDenseNet(nn.Module):
    """reference FCDenseNet (tiramisu.py:93-205; segtpu ``FCDenseNet``):
    first conv, down path of dense blocks and transitions, bottleneck, up
    path whose blocks return only their new features except the last, and a
    1x1 head. ``remat``: per-dense-block rematerialisation in training;
    ``packed``, ``remat_policy``, ``s2d``: module docstring."""

    def __init__(self, in_channels: int = 3, down_blocks: Sequence[int] = (5, 5, 5, 5, 5),
                 up_blocks: Sequence[int] = (5, 5, 5, 5, 5), bottleneck_layers: int = 5,
                 growth_rate: int = 16, out_chans_first_conv: int = 48, n_classes: int = 12,
                 remat: bool = False, packed: bool = False, remat_policy: Optional[str] = None,
                 s2d: bool = False):
        super().__init__()
        self.remat, self.packed, self.remat_policy, self.s2d = remat, packed, remat_policy, s2d
        self._check_options()
        self.firstconv = Conv(in_channels, out_chans_first_conv, 3, padding=1)
        cur, skips = out_chans_first_conv, []
        self.denseBlocksDown, self.transDownBlocks = nn.ModuleList(), nn.ModuleList()
        for n in down_blocks:
            self.denseBlocksDown.append(DenseBlock(cur, growth_rate, n))
            cur += growth_rate * n
            skips.insert(0, cur)
            self.transDownBlocks.append(TransitionDown(cur))
        self.bottleneck = Bottleneck(cur, growth_rate, bottleneck_layers)
        prev = growth_rate * bottleneck_layers
        self.transUpBlocks, self.denseBlocksUp = nn.ModuleList(), nn.ModuleList()
        for i, n in enumerate(up_blocks):
            last = i == len(up_blocks) - 1
            self.transUpBlocks.append(TransitionUp(prev, prev))
            cur = prev + skips[i]
            self.denseBlocksUp.append(DenseBlock(cur, growth_rate, n, upsample=not last))
            prev = growth_rate * n
        self.finalConv = Conv(cur + prev, n_classes, 1)

    def _check_options(self) -> None:
        if self.remat_policy not in (None, "conv_in"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; segtpu has 'conv_in'")
        if self.remat and self.remat_policy is not None:
            raise ValueError("remat and remat_policy are exclusive")

    def _block(self, block: nn.Module, x: torch.Tensor, in_parts=None) -> torch.Tensor:
        options = dict(conv_in=self.remat_policy == "conv_in")
        if in_parts is not None:
            options["in_parts"] = in_parts
        else:
            options["packed"] = self.packed
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(block, x, **options)
        return block(x, **options)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_options()
        skips = []
        blocks = list(zip(self.denseBlocksDown, self.transDownBlocks))
        if self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            dense, down = blocks.pop(0)
            out = s2d_conv(self.firstconv, s2d(x))
            parts = (self.firstconv.out_channels,)
            out = self._block(dense, out, in_parts=parts)
            parts += (dense.growth_rate,) * len(dense.layers)
            skips.append((out, parts))
            out = down(out, in_parts=parts)
        else:
            out = self.firstconv(x)
        for dense, down in blocks:
            out = self._block(dense, out)
            skips.append(out)
            out = down(out)
        out = self._block(self.bottleneck, out)
        for up, dense in zip(self.transUpBlocks, self.denseBlocksUp):
            skip = skips.pop()
            if isinstance(skip, tuple):
                skip = d2s_parts(*skip)
            out = self._block(dense, up(out, skip))
        return float_logits(self.finalConv(out))


def FCDenseNet57(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(4,) * 5, up_blocks=(4,) * 5, bottleneck_layers=4,
                      growth_rate=12, out_chans_first_conv=48, n_classes=n_classes, **kw)


def FCDenseNet67(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(5,) * 5, up_blocks=(5,) * 5, bottleneck_layers=5,
                      growth_rate=16, out_chans_first_conv=48, n_classes=n_classes, **kw)


def FCDenseNet103(n_classes: int = 1, **kw) -> FCDenseNet:
    return FCDenseNet(down_blocks=(4, 5, 7, 10, 12), up_blocks=(12, 10, 7, 5, 4),
                      bottleneck_layers=15, growth_rate=16, out_chans_first_conv=48,
                      n_classes=n_classes, **kw)
