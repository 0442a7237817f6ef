"""ADMMNet: the two-dual ADMM loop with fixed penalties and a frozen,
separately trained denoiser (counterpart of
``galaxy_deconv_tpu/models/admmnet.py``; the reference's
``models/ADMMNet.py``).

rho1 = rho2 = 0.5; the denoiser's weights come from a trained ``ResUNet``
(the denoising task) and stay fixed in training (``create_train_state``'s
``frozen_mask_fn``).  The output is ``x * alpha``.

Two options fix the reference's quirks, off by default:
``denoiser_scale="adu"`` feeds the denoiser alpha-scaled inputs,
z = D((x + u1) * alpha) / alpha, the scale it was trained on (the reference
feeds it the unit-scale x + u1); ``poisson_prox="exact"`` uses the exact
Poisson prox in place of the reference's wrong root.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from galaxy_deconv_tpu_torch.models.unrolled_admm import (
    make_denoiser,
    v_update_gaussian,
    v_update_poisson,
    v_update_poisson_exact,
    wiener_init,
    x_update_two_dual,
)
from galaxy_deconv_tpu_torch.ops import fourier


class ADMMNet(nn.Module):
    """``forward(obs, psf, alpha)`` -> (B, H, W) float32."""

    def __init__(self, n_iters: int = 8, llh: str = "Poisson", denoiser: str = "ResUNet",
                 features: Sequence[int] = (64, 128, 256, 512), rho1: float = 0.5, rho2: float = 0.5,
                 denoiser_scale: str = "unit", poisson_prox: str = "reference", dtype: torch.dtype = torch.float32):
        super().__init__()
        if denoiser_scale not in ("unit", "adu"):
            raise ValueError(f"denoiser_scale must be 'unit' or 'adu', got {denoiser_scale!r}")
        if poisson_prox not in ("reference", "exact"):
            raise ValueError(f"poisson_prox must be 'reference' or 'exact', got {poisson_prox!r}")
        self.n_iters = n_iters
        self.llh = llh
        self.rho1, self.rho2 = rho1, rho2
        self.denoiser_scale = denoiser_scale
        self.poisson_prox = poisson_prox
        self.dtype = dtype
        self.net_name, net = make_denoiser(denoiser, features, dtype)
        self.add_module(self.net_name, net)

    def _denoise(self, z: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.net_name)(z[:, None].to(self.dtype))[:, 0].float()

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        B = obs.shape[0]
        alpha = alpha.reshape(B).float()[:, None, None]
        y = obs.float().clamp_min(0.0)
        H = fourier.psf_to_otf(psf)
        Ht, HtH = H.conj(), H.abs() ** 2

        x = wiener_init(y, Ht, HtH, alpha)
        z, v = x, y
        u1, u2 = torch.zeros_like(x), torch.zeros_like(y)
        rho1, rho2 = self.rho1, self.rho2
        for _ in range(self.n_iters):
            Hx = fourier.conv_fft(H, x)
            if self.llh == "Poisson" and self.poisson_prox == "exact":
                v = v_update_poisson_exact(Hx + u2, y, rho2, alpha)
            elif self.llh == "Poisson":
                v = v_update_poisson(Hx + u2, y, rho2, alpha)
            else:
                v = v_update_gaussian(Hx + u2, y / alpha, rho2)
            if self.denoiser_scale == "adu":
                z = self._denoise((x + u1) * alpha) / alpha
            else:
                z = self._denoise(x + u1)
            # the reference pairs rho1 with |H|^2 here too (ADMMNet.py:16)
            x = x_update_two_dual(z, u1, v, u2, H, Ht, HtH, rho1, rho2)
            u1 = u1 + x - z
            u2 = u2 + fourier.conv_fft(H, x) - v
        return (x * alpha).float()
