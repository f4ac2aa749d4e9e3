"""U-Net family: UNet, UNetABN, ZF_UNET, Afterburner (counterpart of
segtpu/models/unet.py; reference lib/models/unet.py, unet_abn.py,
zf_unet.py, afterburner.py). NCHW. Each model returns raw logits with
``n_classes`` channels, in fp32 (float64 for a float64 model, a CPU
reference run).

``s2d`` (segtpu unet.py:25-200, :264-340): UNet, UNetABN and ZF_UNET run
their full-resolution level in space-to-depth form when H and W are even
(UNet with nearest upsampling only), and ``s2d_deep`` (UNet without ABN,
ZF_UNET; H and W multiples of 4) the half-resolution level too. The level's
convs run through :func:`layers.s2d_conv`, its normalisations with grouped
statistics, its dropouts with one mask per true channel, the 2x2 pool by
:func:`~segtpu_torch.ops.s2d.s2d_max_pool_exit`, and the upsampling that
feeds it is folded into the expanded kernel (``("fold", c)`` parts). The
modules and the ``state_dict`` are those of normal space; set
``model.s2d = True`` on a built model, as the CLIs' ``--s2d`` does.

Attribute names are the reference's state_dict keys:

* UNet / UNetABN: ``inc.conv.conv.{i}``, ``down{k}.mpconv.1.conv.{i}``,
  ``up{k}.conv.conv.{i}`` (and ``up{k}.up`` with transposed-conv
  upsampling), ``outc.conv``; the double conv is a Sequential of
  (conv 0, BN 1, ReLU 2, conv 3, BN 4, ReLU 5), or (conv 0, ABN 1, conv 2,
  ABN 3) with InPlaceABN. UNetABN has no ``unet.`` prefix, though its segtpu
  tree has one.
* ZF_UNET: ``conv_224 .. up_conv_224`` each with ``l1.conv``, ``l1.bn``,
  ``l2.conv``, ``l2.bn``, then ``conv_final``.
* Afterburner: ``unet.*``.

On CUDA every BatchNorm in training mode takes its statistics and its
backward sums from B1 and its affine from B2; every InPlaceABN runs B1 and
B2 forward and B3 backward, and B2 in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import (BatchNormTorch, Conv, ConvTranspose2dTorch, Dropout2d,
                                        InPlaceABN, float_logits, max_pool, remat, s2d_conv,
                                        upsample_nearest)
from segtpu_torch.ops.s2d import d2s, s2d, s2d_max_pool_exit


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x2 (reference unet.py:6-22). ``s2d=True``: an
    s2d input and output, ``in_parts`` describing a block-wise concat input
    of the first conv (segtpu ``DoubleConv``)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(in_channels, features, 3, padding=1), BatchNormTorch(features),
            nn.ReLU(inplace=True),
            Conv(features, features, 3, padding=1), BatchNormTorch(features),
            nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, s2d: bool = False, in_parts=None) -> torch.Tensor:
        if not s2d:
            return self.conv(x)
        conv0, bn0, _, conv1, bn1, _ = self.conv
        x = F.relu(bn0(s2d_conv(conv0, x, in_parts=in_parts), (bn0.features,)), inplace=True)
        return F.relu(bn1(s2d_conv(conv1, x), (bn1.features,)), inplace=True)


class DoubleConvABN(nn.Module):
    """(conv3x3 -> InPlaceABN) x2 (reference unet_abn.py:6-22): the fused ABN
    with the from-output backward. ``s2d`` and ``in_parts`` as
    :class:`DoubleConv`'s; the ABNs combine their statistics over the
    sub-positions."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(Conv(in_channels, features, 3, padding=1), InPlaceABN(features),
                                  Conv(features, features, 3, padding=1), InPlaceABN(features))

    def forward(self, x: torch.Tensor, s2d: bool = False, in_parts=None) -> torch.Tensor:
        if not s2d:
            return self.conv(x)
        conv0, abn0, conv1, abn1 = self.conv
        x = abn0(s2d_conv(conv0, x, in_parts=in_parts), (abn0.features,))
        return abn1(s2d_conv(conv1, x), (abn1.features,))


def _pad_to_match(small: torch.Tensor, big: torch.Tensor) -> torch.Tensor:
    """``small`` zero-padded on H and W to ``big``'s size, by ``(d // 2,
    d - d // 2)`` on each (segtpu ``_pad_to_match``; reference
    unet.py:60-64)."""
    dh, dw = big.shape[2] - small.shape[2], big.shape[3] - small.shape[3]
    if dh == 0 and dw == 0:
        return small
    return F.pad(small, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


class _Inc(nn.Module):
    def __init__(self, in_channels: int, features: int, block: type):
        super().__init__()
        self.conv = block(in_channels, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Down(nn.Module):
    """2x2 max pool, then the double conv (reference unet.py:35-45)."""

    def __init__(self, in_channels: int, features: int, block: type):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), block(in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class _Up(nn.Module):
    """2x upsample, pad to the skip, concat ``[skip, upsampled]``, double conv
    (reference unet.py:48-67). The upsampling is nearest, or with
    ``upsample=False`` a ``ConvTranspose2d(C, C, 2, stride=2)`` of the
    lower level's C = ``in_channels // 2`` channels, ``up`` (reference
    unet.py:54-56; segtpu unet.py:122-125).

    The upsampled tensor is padded to the skip's size, as the reference
    does. segtpu pads the skip to the upsampled tensor instead
    (segtpu/models/unet.py:126), which is the same where H and W are
    multiples of 16 and raises elsewhere."""

    def __init__(self, in_channels: int, features: int, block: type, upsample: bool = True):
        super().__init__()
        self.up = None if upsample else ConvTranspose2dTorch(in_channels // 2,
                                                             in_channels // 2, 2, 2)
        self.conv = block(in_channels, features)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        if s2d:
            # segtpu's s2d _Up: the s2d skip and the half-resolution x1 in
            # one concat, x1's nearest upsampling folded into the kernel
            parts = (("s2d", x2.shape[1] // 4), ("fold", x1.shape[1]))
            return self.conv(torch.cat([x2, x1], 1), s2d=True, in_parts=parts)
        x1 = upsample_nearest(x1) if self.up is None else self.up(x1)
        x1 = _pad_to_match(x1, x2)
        return self.conv(torch.cat([x2, x1], 1))


class _OutConv(nn.Module):
    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.conv = Conv(in_channels, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    """Classic U-Net (reference lib/models/unet.py:80-107; segtpu ``UNet``):
    4x down by max pool, 4x up by nearest upsampling with concatenated
    skips, ``Dropout2d(0.5)`` before the 1x1 head. ``upsample=False``:
    transposed convolutions in place of the nearest upsampling. ``s2d``,
    ``s2d_deep``: module docstring."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, n_filters: int = 32,
                 abn: bool = False, final_dropout: float = 0.5, upsample: bool = True,
                 s2d: bool = False, s2d_deep: bool = False):
        super().__init__()
        self.abn, self.upsample, self.s2d, self.s2d_deep = abn, upsample, s2d, s2d_deep
        f, block = n_filters, DoubleConvABN if abn else DoubleConv
        self.inc = _Inc(n_channels, f, block)
        self.down1 = _Down(f, 2 * f, block)
        self.down2 = _Down(2 * f, 4 * f, block)
        self.down3 = _Down(4 * f, 8 * f, block)
        self.down4 = _Down(8 * f, 8 * f, block)
        self.up1 = _Up(16 * f, 4 * f, block, upsample)
        self.up2 = _Up(8 * f, 2 * f, block, upsample)
        self.up3 = _Up(4 * f, f, block, upsample)
        self.up4 = _Up(2 * f, f, block, upsample)
        self.finaldrop = Dropout2d(final_dropout)
        self.outc = _OutConv(f, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        use_s2d = self.s2d and self.upsample and h % 2 == 0 and w % 2 == 0
        # level 1 in s2d (segtpu's s2d_deep): only the BatchNorm blocks
        deep = use_s2d and self.s2d_deep and not self.abn and h % 4 == 0 and w % 4 == 0
        if not use_s2d:
            x1 = self.inc(x)
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            x5 = self.down4(x4)
            y = self.up1(x5, x4)
            y = self.up2(y, x3)
            y = self.up3(y, x2)
            y = self.up4(y, x1)
            return float_logits(self.outc(self.finaldrop(y)))
        x1s = self.inc.conv(s2d(x), s2d=True)
        pooled = s2d_max_pool_exit(x1s)
        if deep:
            x2s = self.down1.mpconv[1](s2d(pooled), s2d=True)
            x3 = self.down2.mpconv[1](s2d_max_pool_exit(x2s))
        else:
            x2 = self.down1.mpconv[1](pooled)
            x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = d2s(self.up3(y, x2s, s2d=True)) if deep else self.up3(y, x2)
        y = self.finaldrop(self.up4(y, x1s, s2d=True), groups=4)
        return float_logits(d2s(s2d_conv(self.outc.conv, y)))


class UNetABN(UNet):
    """UNet with fused InPlaceABN blocks (reference lib/models/unet_abn.py;
    segtpu ``UNetABN``): the reference's keys, without segtpu's ``unet``
    level. ``s2d``: the full-resolution level with grouped-statistics ABN."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1, n_filters: int = 32,
                 s2d: bool = False):
        super().__init__(n_channels, n_classes, n_filters, abn=True, s2d=s2d)


class _ZFConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = Conv(in_channels, features, 3, padding=1)
        self.bn = BatchNormTorch(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)), inplace=True)

    def forward_s2d(self, x: torch.Tensor, in_parts=None) -> torch.Tensor:
        y = s2d_conv(self.conv, x, in_parts=in_parts)
        return F.relu(self.bn(y, (self.bn.features,)), inplace=True)


class _ZFDoubleConv(nn.Module):
    """conv-BN-ReLU x2, then ``Dropout2d`` (reference zf_unet.py:5-32);
    ``s2d`` and ``in_parts`` as :class:`DoubleConv`'s."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.l1 = _ZFConvBNReLU(in_channels, features)
        self.l2 = _ZFConvBNReLU(features, features)
        self.drop = Dropout2d(dropout)

    def forward(self, x: torch.Tensor, s2d: bool = False, in_parts=None) -> torch.Tensor:
        if not s2d:
            return self.drop(self.l2(self.l1(x)))
        y = self.l2.forward_s2d(self.l1.forward_s2d(x, in_parts))
        return self.drop(y, groups=4)


class ZF_UNET(nn.Module):
    """ZF_UNET_224 (reference lib/models/zf_unet.py:35-95; segtpu
    ``ZF_UNET``): 6 levels, ``filters`` to 32 x ``filters`` channels,
    ``Dropout2d(dropout_val)`` after every block, nearest upsampling and
    concat ``[upsampled, skip]``. H and W must be multiples of 32.

    ``remat``: in training, each block runs through :func:`layers.remat`: its
    activations are recomputed in the backward pass instead of kept, and its
    running statistics are updated once. ``s2d``, ``s2d_deep``: module
    docstring."""

    LEVELS = ("224", "112", "56", "28", "14", "7")

    def __init__(self, input_channels: int = 3, num_classes: int = 1, filters: int = 32,
                 dropout_val: float = 0.2, remat: bool = False, s2d: bool = False,
                 s2d_deep: bool = False):
        super().__init__()
        self.remat, self.s2d, self.s2d_deep = remat, s2d, s2d_deep
        f = filters
        widths = [f * 2 ** i for i in range(6)]
        cin = input_channels
        for level, w in zip(self.LEVELS, widths):
            setattr(self, f"conv_{level}", _ZFDoubleConv(cin, w, dropout_val))
            cin = w
        for level, w in zip(self.LEVELS[-2::-1], widths[-2::-1]):
            setattr(self, f"up_conv_{level}", _ZFDoubleConv(cin + w, w, dropout_val))
            cin = w
        self.conv_final = Conv(f, num_classes, 1)

    def _block(self, name: str, x: torch.Tensor, **s2d_args) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(block, x, **s2d_args)
        return block(x, **s2d_args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        use_s2d = self.s2d and h % 2 == 0 and w % 2 == 0
        deep = use_s2d and self.s2d_deep and h % 4 == 0 and w % 4 == 0
        if not use_s2d:
            skips = []
            for i, level in enumerate(self.LEVELS):
                x = self._block(f"conv_{level}", x if i == 0 else max_pool(x))
                skips.append(x)
            for level, skip in zip(self.LEVELS[-2::-1], skips[-2::-1]):
                x = self._block(f"up_conv_{level}", torch.cat([upsample_nearest(x), skip], 1))
            return float_logits(self.conv_final(x))
        c224s = self._block("conv_224", s2d(x), s2d=True)
        pooled = s2d_max_pool_exit(c224s)
        if deep:
            c112s = self._block("conv_112", s2d(pooled), s2d=True)
            x = s2d_max_pool_exit(c112s)
        else:
            c112 = self._block("conv_112", pooled)
            x = max_pool(c112)
        skips = []
        for i, level in enumerate(self.LEVELS[2:]):
            x = self._block(f"conv_{level}", x if i == 0 else max_pool(x))
            skips.append(x)
        for level, skip in zip(("14", "28", "56"), skips[-2::-1]):
            x = self._block(f"up_conv_{level}", torch.cat([upsample_nearest(x), skip], 1))
        if deep:
            parts = (("fold", x.shape[1]), ("s2d", c112s.shape[1] // 4))
            x = d2s(self._block("up_conv_112", torch.cat([x, c112s], 1), s2d=True,
                                in_parts=parts))
        else:
            x = self._block("up_conv_112", torch.cat([upsample_nearest(x), c112], 1))
        # the nearest upsampling that feeds up_conv_224 is folded into its
        # expanded kernel (segtpu unet.py:330-339)
        parts = (("fold", x.shape[1]), ("s2d", c224s.shape[1] // 4))
        x = self._block("up_conv_224", torch.cat([x, c224s], 1), s2d=True, in_parts=parts)
        return float_logits(d2s(s2d_conv(self.conv_final, x)))


class Afterburner(nn.Module):
    """1-channel UNet that refines a frozen head's sigmoid output (reference
    lib/models/afterburner.py:8-15; segtpu ``Afterburner``)."""

    def __init__(self, n_channels: int = 1):
        super().__init__()
        self.unet = UNet(n_channels=n_channels, n_classes=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.unet(x)
