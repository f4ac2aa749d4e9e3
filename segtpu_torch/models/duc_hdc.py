"""ResNetDUC and ResNetDUCHDC (counterpart of segtpu/models/duc_hdc.py;
reference lib/models/duc_hdc.py:24-101): ResNet-152 at output stride 8,
with dilations 2 and 4 (DUC) or the hybrid dilation cycles (1, 2, 5, 9)
and (5, 9, 17) (HDC), then dense upsampling convolution: conv3x3 ->
BatchNorm -> ReLU -> pixel shuffle by 8. Input sides should be multiples
of 8.

Keys: ``layer0.{0,1}`` (conv1, bn1; then relu and the max-pool),
``layer1..4``, ``duc.conv``, ``duc.bn``. In training mode the 156
BatchNorms run B1 and B2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.encoders.resnet import resnet152
from segtpu_torch.models.layers import BatchNormTorch, Conv, float_logits, pixel_shuffle


class DenseUpsamplingConvModule(nn.Module):
    """conv3x3 to r^2 x classes -> BatchNorm -> ReLU -> pixel shuffle by r
    (reference duc_hdc.py:7-21)."""

    def __init__(self, down_factor: int, in_dim: int, num_classes: int):
        super().__init__()
        dim = down_factor ** 2 * num_classes
        self.down_factor = down_factor
        self.conv = Conv(in_dim, dim, 3, padding=1)
        self.bn = BatchNormTorch(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(F.relu(self.bn(self.conv(x))), self.down_factor)


class ResNetDUC(nn.Module):
    """reference duc_hdc.py:24-61 (``hdc``: :64-101); logits in fp32
    (float64 for a float64 model)."""

    def __init__(self, num_classes: int = 1, num_channels: int = 3, hdc: bool = False):
        super().__init__()
        enc = resnet152(dilated=not hdc, hdc=hdc, num_channels=num_channels)
        self.layer0 = nn.Sequential(enc.conv1, enc.bn1, nn.ReLU(inplace=True), enc.maxpool)
        self.layer1, self.layer2, self.layer3, self.layer4 = (enc.layer1, enc.layer2,
                                                              enc.layer3, enc.layer4)
        self.duc = DenseUpsamplingConvModule(8, 2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layer1(self.layer0(x))
        y = self.layer4(self.layer3(self.layer2(y)))
        return float_logits(self.duc(y))


def ResNetDUCHDC(num_classes: int = 1, num_channels: int = 3) -> ResNetDUC:
    return ResNetDUC(num_classes=num_classes, num_channels=num_channels, hdc=True)
