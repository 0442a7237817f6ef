"""Closed-form baseline solvers: the Wiener filter and the identity
(counterparts of ``galaxy_deconv_tpu/models/simple.py``)."""

from __future__ import annotations

import torch
from torch import nn

from galaxy_deconv_tpu_torch.ops import fourier


class Wiener(nn.Module):
    """One-shot Wiener deconvolution x = Ht Y / (|H|^2 + nsr / alpha).

    The reference's ``models/Wiener.py`` with its noise-to-signal constant
    350 as ``nsr``.  Circular convolution at the stamp size; no parameters.
    """

    def __init__(self, nsr: float = 350.0):
        super().__init__()
        self.nsr = nsr

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        alpha = alpha.reshape(obs.shape[0]).float()[:, None, None]
        H = fourier.psf_to_otf(psf)
        numerator = H.conj() * fourier.rfft2(obs)
        divisor = H.abs() ** 2 + self.nsr / alpha
        return fourier.irfft2(numerator / divisor, obs.shape[-2:])


class NoDeconv(nn.Module):
    """The identity: the harness's 'No_Deconv' baseline."""

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        return obs
