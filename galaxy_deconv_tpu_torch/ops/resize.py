"""Average downsampling, the ResUNet's edge padding and the XDenseUNet's
nearest upsampling (counterparts of ``galaxy_deconv_tpu/ops/resize.py:15-50``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def average_downsample(x: torch.Tensor, rate: int = 4) -> torch.Tensor:
    """Average-pool the trailing two axes by ``rate`` (non-overlapping)."""
    H, W = x.shape[-2], x.shape[-1]
    if H % rate or W % rate:
        raise ValueError(f"image size ({H},{W}) not divisible by rate {rate}")
    return x.reshape(*x.shape[:-2], H // rate, rate, W // rate, rate).mean(dim=(-3, -1))


def pad_to_multiple_edge(x: torch.Tensor, multiple: int = 8) -> tuple[torch.Tensor, tuple[int, int]]:
    """Replication-pad bottom/right of an NCHW tensor so H, W are multiples.

    Returns the padded tensor and the original (H, W) for cropping back.  The
    JAX version pads NHWC; here the spatial axes are the trailing two.
    """
    H, W = x.shape[-2], x.shape[-1]
    ph = (-H) % multiple
    pw = (-W) % multiple
    if ph == 0 and pw == 0:
        return x, (H, W)
    return F.pad(x, (0, pw, 0, ph), mode="replicate"), (H, W)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NCHW tensor's spatial axes by an
    integer factor (the JAX version upsamples NHWC)."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)
