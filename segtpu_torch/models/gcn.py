"""Global Convolutional Network: GCN34 and GCN152 (counterpart of
segtpu/models/gcn.py; reference lib/models/gcn152.py:64-167).

Separable large-kernel conv pairs (k = 7) with a channel dropout ahead,
boundary-refine residual modules, and a bilinear (align_corners) upsample
cascade over a ResNet-34 or ResNet-152. The encoder's modules sit where
the reference keeps them: ``layer0`` = (conv1, bn1, relu), ``layer1`` =
(maxpool, layer1), ``layer2..4``; so its keys are ``layer0.{0,1}.*`` and
``layer1.1.*``. In training mode the encoder's BatchNorms (36 or 155) run
B1 and B2; the GCN head has no normalisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.models.encoders.resnet import ResNetEncoder, resnet34, resnet152
from segtpu_torch.models.layers import Conv, Dropout2d, float_logits, upsample_bilinear


class GlobalConvModule(nn.Module):
    """(k x 1 -> 1 x k) + (1 x k -> k x 1) after ``Dropout2d(0.1)``
    (reference gcn152.py:9-34)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 7):
        super().__init__()
        k, pad = kernel_size, (kernel_size - 1) // 2
        self.pre_drop = Dropout2d(0.1)
        self.conv_l1 = Conv(in_dim, out_dim, (k, 1), padding=(pad, 0))
        self.conv_l2 = Conv(out_dim, out_dim, (1, k), padding=(0, pad))
        self.conv_r1 = Conv(in_dim, out_dim, (1, k), padding=(0, pad))
        self.conv_r2 = Conv(out_dim, out_dim, (k, 1), padding=(pad, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_drop(x)
        return self.conv_l2(self.conv_l1(x)) + self.conv_r2(self.conv_r1(x))


class BoundaryRefineModule(nn.Module):
    """x + conv3x3(relu(conv3x3(x))) (reference gcn152.py:37-49)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, padding=1)
        self.conv2 = Conv(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class GCN(nn.Module):
    """The GCN34/GCN152 body over ``encoder`` (reference gcn152.py:64-167);
    logits in fp32 (float64 for a float64 model)."""

    def __init__(self, encoder: ResNetEncoder, num_classes: int = 1):
        super().__init__()
        nc = num_classes
        self.layer0 = nn.Sequential(encoder.conv1, encoder.bn1, nn.ReLU(inplace=True))
        self.layer1 = nn.Sequential(encoder.maxpool, encoder.layer1)
        self.layer2, self.layer3, self.layer4 = encoder.layer2, encoder.layer3, encoder.layer4
        for i, w in enumerate(reversed(encoder.widths), 1):
            setattr(self, f"gcm{i}", GlobalConvModule(w, nc, 7))
        for i in range(1, 10):
            setattr(self, f"brm{i}", BoundaryRefineModule(nc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fm0 = self.layer0(x)
        fm1 = self.layer1(fm0)
        fm2 = self.layer2(fm1)
        fm3 = self.layer3(fm2)
        fm4 = self.layer4(fm3)

        gcfm1 = self.brm1(self.gcm1(fm4))
        gcfm2 = self.brm2(self.gcm2(fm3))
        gcfm3 = self.brm3(self.gcm3(fm2))
        gcfm4 = self.brm4(self.gcm4(fm1))

        def up(v, ref):
            return upsample_bilinear(v, ref.shape[2:])

        fs1 = self.brm5(up(gcfm1, fm3) + gcfm2)
        fs2 = self.brm6(up(fs1, fm2) + gcfm3)
        fs3 = self.brm7(up(fs2, fm1) + gcfm4)
        fs4 = self.brm8(up(fs3, fm0))
        return float_logits(self.brm9(up(fs4, x)))


def GCN34(num_classes: int = 1, num_channels: int = 3) -> GCN:
    return GCN(resnet34(num_channels=num_channels), num_classes)


def GCN152(num_classes: int = 1, num_channels: int = 3) -> GCN:
    return GCN(resnet152(num_channels=num_channels), num_classes)
