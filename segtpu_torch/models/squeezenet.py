"""SqueezeNet encoder-decoder (counterpart of segtpu/models/squeezenet.py;
reference lib/models/squeezenet.py:68-151): Fire and DFire squeeze-expand
modules with ELU, additive skips, nearest upsampling. It has no
normalisation layer, so it runs no kernel of this repo.

``s2d`` (segtpu squeezenet.py:62-115): with even H and W, the 96-channel
stem conv runs in space-to-depth form and its skip stays s2d; the head adds
``d2``'s nearest upsampling as a channel tile in s2d form and its 1x1 conv
converts once at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.layers import Conv, float_logits, max_pool, s2d_conv, upsample_nearest
from segtpu_torch.ops.s2d import d2s, s2d, s2d_max_pool_exit, s2d_tile_channels


class Fire(nn.Module):
    """squeeze 1x1 -> ELU -> [expand1x1 || expand3x3] -> ELU, concatenated
    (reference squeezenet.py:7-27)."""

    def __init__(self, in_channels: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.squeeze = Conv(in_channels, squeeze, 1)
        self.expand1x1 = Conv(squeeze, expand1x1, 1)
        self.expand3x3 = Conv(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.elu(self.squeeze(x))
        return torch.cat([F.elu(self.expand1x1(s)), F.elu(self.expand3x3(s))], 1)


class DFire(nn.Module):
    """[expand1x1 || expand3x3] -> ELU, concatenated -> squeeze 1x1 -> ELU
    (reference squeezenet.py:29-52)."""

    def __init__(self, in_channels: int, squeeze: int, expand1x1: int, expand3x3: int):
        super().__init__()
        self.expand1x1 = Conv(in_channels, expand1x1, 1)
        self.expand3x3 = Conv(in_channels, expand3x3, 3, padding=1)
        self.squeeze = Conv(expand1x1 + expand3x3, squeeze, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([F.elu(self.expand1x1(x)), F.elu(self.expand3x3(x))], 1)
        return F.elu(self.squeeze(y))


# (squeeze, expand1x1, expand3x3) of fire2..9 and of dfire9..2
_FIRES = {2: (16, 64, 64), 3: (16, 64, 64), 4: (48, 128, 128), 5: (48, 128, 128),
          6: (48, 192, 192), 7: (48, 192, 192), 8: (64, 256, 256), 9: (64, 256, 256)}
_DFIRES = {9: (512, 256, 256), 8: (384, 256, 256), 7: (384, 192, 192), 6: (256, 192, 192),
           5: (256, 128, 128), 4: (128, 128, 128), 3: (128, 64, 64), 2: (96, 48, 48)}


class SqueezeNet(nn.Module):
    """reference lib/models/squeezenet.py:68-151; logits in fp32 (float64
    for a float64 model)."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.conv1 = Conv(in_channels, 96, 3, padding=1)
        width = 96
        for i, (sq, e1, e3) in _FIRES.items():
            setattr(self, f"fire{i}", Fire(width, sq, e1, e3))
            width = e1 + e3
        self.conv10 = nn.Sequential(Conv(width, 1024, 1), nn.ELU())
        self.dconv10 = nn.Sequential(Conv(1024, 512, 1), nn.ELU())
        width = 512
        for i, (sq, e1, e3) in _DFIRES.items():
            setattr(self, f"dfire{i}", DFire(width, sq, e1, e3))
            width = sq
        self.dconv1 = Conv(width, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        use_s2d = self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
        if use_s2d:
            conv1s = s2d_conv(self.conv1, s2d(x))
            pool1 = s2d_max_pool_exit(conv1s)
        else:
            conv1 = self.conv1(x)
            pool1 = max_pool(conv1)
        fire4 = self.fire4(self.fire3(self.fire2(pool1)))
        fire8 = self.fire8(self.fire7(self.fire6(self.fire5(max_pool(fire4)))))
        center = self.dconv10(self.conv10(self.fire9(max_pool(fire8))))
        d9 = upsample_nearest(self.dfire9(center))
        d5 = self.dfire5(self.dfire6(self.dfire7(self.dfire8(d9 + fire8))))
        d2 = self.dfire2(self.dfire3(self.dfire4(upsample_nearest(d5) + fire4)))
        if use_s2d:
            return float_logits(d2s(s2d_conv(self.dconv1, conv1s + s2d_tile_channels(d2))))
        return float_logits(self.dconv1(upsample_nearest(d2) + conv1))
