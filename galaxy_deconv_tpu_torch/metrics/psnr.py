"""PSNR (counterpart of ``galaxy_deconv_tpu/metrics/psnr.py``; the reference's
``utils/utils_test.py:7-25``)."""

from __future__ import annotations

import torch


def _unit_range(img: torch.Tensor) -> torch.Tensor:
    lo = img.amin(dim=(-2, -1), keepdim=True)
    return (img - lo) / (img.amax(dim=(-2, -1), keepdim=True) - lo)


def psnr(img1: torch.Tensor, img2: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Batched PSNR of (..., H, W) image pairs, reduced over the last two axes.

    ``normalize=True`` rescales each image to [0, 1] by its own range first
    (the reference divides img2 by img1's range, a bug the JAX package does
    not copy); otherwise the peak is the larger of the two images' maxima.
    """
    img1, img2 = img1.float(), img2.float()
    if normalize:
        img1, img2 = _unit_range(img1), _unit_range(img2)
        pixel_max = 1.0
    else:
        pixel_max = torch.maximum(img1.amax(dim=(-2, -1)), img2.amax(dim=(-2, -1)))
    mse = ((img1 - img2) ** 2).mean(dim=(-2, -1))
    return 20.0 * torch.log10(pixel_max / torch.sqrt(mse))
