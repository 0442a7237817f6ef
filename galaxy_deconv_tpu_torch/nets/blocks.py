"""Conv blocks of the ResUNet and the SubNet, NCHW.

Counterparts of ``galaxy_deconv_tpu/nets/blocks.py:20-81``.  Flax's "SAME"
3x3 convolution is ``padding=1``; every ResUNet convolution is bias-free;
flax BatchNorm momentum 0.9 is torch momentum 0.1, eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ResBlock(nn.Module):
    """x + Conv3x3 -> ReLU -> Conv3x3, bias-free, same width in and out."""

    def __init__(self, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv1(F.relu(self.conv0(x)))


class DownConv(nn.Conv2d):
    """Stride-2 2x2 bias-free convolution (downsample)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 2, stride=2, bias=False)


class UpConvTranspose(nn.ConvTranspose2d):
    """Stride-2 2x2 bias-free transposed convolution (upsample).

    Its kernel is flax's spatially flipped: see ``utils/convert_flax.py``.
    """

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 2, stride=2, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm as flax's ``BatchNorm(dtype=...)`` computes it: statistics and
    affine parameters stay float32, the normalisation runs in float32, and
    the result is cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class DoubleConv(nn.Module):
    """(Conv3x3 -> BatchNorm -> ReLU) x2, convolutions with bias, computing in
    ``dtype`` (BatchNorm in float32, see :class:`BatchNorm2d`)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = nn.Conv2d(in_features, features, 3, padding=1, dtype=dtype)
        self.bn0 = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, dtype=dtype)
        self.bn1 = BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))
