"""Richardson-Lucy deconvolution (counterpart of
``galaxy_deconv_tpu/models/richardson_lucy.py``).

The reference's ``models/Richard_Lucy.py``: multiplicative updates
x <- x * Ht(y / Hx) / Ht(1) with the circular FFT convolution, started at the
clamped observation.  ``eps`` guards the ratio; the default 0 keeps the
reference's unguarded division, so where Hx is at the FFT's round-off the
ratio follows that round-off, which differs between FFT libraries.
"""

from __future__ import annotations

import torch
from torch import nn

from galaxy_deconv_tpu_torch.ops import fourier


class RichardsonLucy(nn.Module):
    def __init__(self, n_iters: int = 30, eps: float = 0.0):
        super().__init__()
        self.n_iters = n_iters
        self.eps = eps

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor | None = None) -> torch.Tensor:
        y = obs.float().clamp_min(0.0)
        H = fourier.psf_to_otf(psf)
        Ht = H.conj()
        # Ht applied to the all-ones image, through the FFT as the reference does
        divisor = fourier.conv_fft(Ht, torch.ones_like(y))
        x = y
        for _ in range(self.n_iters):
            Hx = fourier.conv_fft(H, x)
            ratio = y / (Hx + self.eps) if self.eps else y / Hx
            x = x * fourier.conv_fft(Ht, ratio) / divisor
        return x
