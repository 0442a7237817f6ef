"""Conv blocks of the ResUNet, the SubNet and the XDenseUNet, NCHW.

Counterparts of ``galaxy_deconv_tpu/nets/blocks.py:20-102``.  Flax's "SAME"
3x3 convolution is ``padding=1``; every ResUNet convolution is bias-free;
flax BatchNorm momentum 0.9 is torch momentum 0.1, eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from galaxy_deconv_tpu_torch.parallel.batch import batch_sum, in_global_batch


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
    the result is cast back to the input's dtype.

    In train mode it normalises with the batch statistics and updates the
    running ones as flax does, which torch's own BatchNorm does not: the
    variance is the biased ``mean(x^2) - mean(x)^2`` clamped at 0 (torch
    stores the unbiased n/(n-1) one), and running = (1 - momentum) * running
    + momentum * batch, flax's momentum 0.9 being this class's 0.1.

    Inside ``parallel.global_batch(group)`` (a data-parallel train step) the
    statistics are the global batch's, as under a JAX mesh: the per-channel
    sums of x and x^2 and the count are all-reduced in float32 over the
    group, differentiably (``parallel/batch.py``), then divided by the global
    count.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x.float()).to(x.dtype)
        xf = x.float()
        if in_global_batch():
            C = xf.shape[1]
            sums = batch_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                        xf.new_full((1,), xf.numel() // C)]))
            mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        else:
            mean, mean2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


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


class SeparableConv(nn.Module):
    """Depthwise ``kernel_size`` conv (``groups`` = channels) then pointwise
    1x1 conv, both bias-free, computing in ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = nn.Conv2d(in_features, in_features, kernel_size, padding=kernel_size // 2,
                                   groups=in_features, bias=False, dtype=dtype)
        self.pointwise = nn.Conv2d(in_features, features, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
