"""Edge padding for the ResUNet (counterpart of ``galaxy_deconv_tpu/ops/resize.py:29-41``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
