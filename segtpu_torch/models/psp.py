"""PSPNet (counterpart of segtpu/models/psp.py; reference
lib/models/psp_net.py:42-96): the stride-8 dilated ResNet-101, the pyramid
pooling module over bins 1, 2, 3 and 6, a 3x3 conv + BatchNorm head with
elementwise dropout, bilinear (align_corners) upsampling to the input, and
an optional auxiliary head on layer3.

Keys are the reference's: ``layer0.{0,1}`` (conv1, bn1; then relu and the
max-pool), ``layer1..4``, ``ppm.features.{i}.{1,2}`` (conv, BatchNorm of
bin i), ``final.{0,1,4}`` and ``aux_logits``. The pyramid's and the head's
BatchNorms take momentum 0.95 (torch ``BatchNorm2d(momentum=.95)``: the
running statistics move 95% of the way to the batch's). In training mode
all 109 BatchNorms run B1 and B2, the pyramid's over M = batch x 1, 4, 9
and 36 rows.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from segtpu_torch.models.encoders.resnet import resnet101
from segtpu_torch.models.layers import BatchNormTorch, Conv, Dropout, float_logits, upsample_bilinear

PSP_MOMENTUM = 0.95


class PyramidPoolingModule(nn.Module):
    """Per bin s: adaptive average pool to s x s (torch's bins
    [floor(i*h/s), ceil((i+1)*h/s))), conv1x1, BatchNorm (momentum 0.95),
    ReLU, bilinear upsampling back; concatenated after the input
    (reference psp_net.py:20-39)."""

    def __init__(self, in_dim: int, reduction_dim: int, setting: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.features = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s), Conv(in_dim, reduction_dim, 1, bias=False),
                          BatchNormTorch(reduction_dim, momentum=PSP_MOMENTUM),
                          nn.ReLU(inplace=True))
            for s in setting])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        return torch.cat([x] + [upsample_bilinear(f(x), hw) for f in self.features], 1)


class PSPNet(nn.Module):
    """reference lib/models/psp_net.py:42-96; logits in fp32 (float64 for a
    float64 model). ``use_aux``: in training mode also the auxiliary
    logits of layer3, ``(out, aux)``."""

    def __init__(self, num_classes: int = 1, num_channels: int = 3, use_aux: bool = False):
        super().__init__()
        enc = resnet101(dilated=True, num_channels=num_channels)
        self.layer0 = nn.Sequential(enc.conv1, enc.bn1, nn.ReLU(inplace=True), enc.maxpool)
        self.layer1, self.layer2, self.layer3, self.layer4 = (enc.layer1, enc.layer2,
                                                              enc.layer3, enc.layer4)
        self.ppm = PyramidPoolingModule(2048, 512)
        self.final = nn.Sequential(
            Conv(2048 + 4 * 512, 512, 3, padding=1, bias=False),
            BatchNormTorch(512, momentum=PSP_MOMENTUM), nn.ReLU(inplace=True), Dropout(0.1),
            Conv(512, num_classes, 1))
        self.use_aux = use_aux
        self.aux_logits = Conv(1024, num_classes, 1) if use_aux else None

    def forward(self, x: torch.Tensor):
        hw = x.shape[2:]
        y = self.layer1(self.layer0(x))
        y = self.layer2(y)
        e3 = self.layer3(y)
        y = self.final(self.ppm(self.layer4(e3)))
        out = float_logits(upsample_bilinear(y, hw))
        if self.training and self.use_aux:
            return out, float_logits(upsample_bilinear(self.aux_logits(e3), hw))
        return out
