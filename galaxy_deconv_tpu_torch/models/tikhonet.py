"""Tikhonet: one-shot Tikhonov deconvolution, then the XDenseUNet (counterpart
of ``galaxy_deconv_tpu/models/tikhonet.py``).

x = F^-1( conj(H) F(y / alpha) / (|H|^2 + lam |L|^2) ) with the Identity
(|L|^2 = 1) or Laplacian regulariser, denoised by the XDenseUNet, times
alpha.  'ShapeNet' is the same model trained with the Shape loss.  As in the
JAX package, ``lam = softplus(lam_raw)`` is a learnt parameter starting at
1 (the reference never registered its ``lam``, so it stayed 1), and the
Laplacian defaults to the reference's six-tap quirk OTF, which the trained
weights need.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from galaxy_deconv_tpu_torch.nets import XDenseUNet
from galaxy_deconv_tpu_torch.ops import fourier

_SOFTPLUS_INV_1 = math.log(math.expm1(1.0))  # softplus(x) = 1  <=>  x = log(e - 1)


def tikhonov_solve(obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor, lam: torch.Tensor,
                   filter: str = "Laplacian", laplacian: str = "reference") -> torch.Tensor:
    """Closed-form Tikhonov-regularised deconvolution at the stamp size.

    ``laplacian="reference"`` uses the reference's quirk OTF
    (:func:`~galaxy_deconv_tpu_torch.ops.fourier.laplacian_otf_reference_quirk`),
    ``"exact"`` the 3x3 stencil's circular embedding.
    """
    B = obs.shape[0]
    alpha = alpha.reshape(B).float()[:, None, None]
    shape = tuple(obs.shape[-2:])
    H = fourier.psf_to_otf(psf)
    numerator = H.conj() * fourier.rfft2(obs / alpha)
    if filter == "Laplacian":
        if laplacian == "reference":
            L = fourier.laplacian_otf_reference_quirk(shape, obs.device)
        else:
            L = fourier.psf_to_otf(fourier.laplacian_kernel(obs.device), shape)
        divisor = H.abs() ** 2 + lam * L.abs() ** 2
    elif filter == "Identity":
        divisor = H.abs() ** 2 + lam
    else:
        raise ValueError(f"unknown Tikhonov filter: {filter}")
    return fourier.irfft2(numerator / divisor, shape)


class Tikhonet(nn.Module):
    """``forward(obs, psf, alpha)`` -> (B, H, W) float32."""

    def __init__(self, filter: str = "Laplacian", laplacian: str = "reference"):
        super().__init__()
        self.filter = filter
        self.laplacian = laplacian
        self.lam_raw = nn.Parameter(torch.empty(()))
        self.xdense_unet = XDenseUNet()
        self.reset_scalars()

    def reset_scalars(self) -> None:
        """flax's initial value of ``lam_raw``: softplus(lam_raw) = 1."""
        with torch.no_grad():
            self.lam_raw.fill_(_SOFTPLUS_INV_1)

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        alpha = alpha.reshape(obs.shape[0]).float()
        x = tikhonov_solve(obs.float().clamp_min(0.0), psf, alpha, F.softplus(self.lam_raw), self.filter,
                           self.laplacian)
        x = self.xdense_unet(x[:, None])[:, 0]
        return (x * alpha[:, None, None]).float()
