"""Unrolled PnP-ADMM with a Poisson or Gaussian likelihood, the two-dual
variant (counterpart of ``galaxy_deconv_tpu/models/unrolled_admm.py``; the
reference's ``models/Unrolled_ADMM.py:153-216``, which its ``test.py``
evaluates).

Against the flagship: circular convolution at the stamp size (no pad/crop),
a likelihood variable v with its own dual u2, per-iteration (rho1, rho2)
from one SubNet with 2n outputs, and the Poisson proximal map in closed
form.  Per iteration:

    v = prox_likelihood(H x + u2)
    z = denoiser(x + u1)                       (PnP)  or soft-threshold (l1)
    x = F^-1( F(rho1 (z - u1) + rho2 Ht(v - u2)) / (rho1 |H|^2 + rho2) )
    u1 += x - z ;  u2 += H x - v

The x-update's denominator pairs rho1 with |H|^2: the reference defines
``X_Update`` twice and the second definition, which wins, swaps the rho
roles.  The trained weights compensate for it, so it is kept (see the JAX
module's docstring).  It is not the flagship's solve, so it stays plain
PyTorch and launches no kernel.  The Poisson output is ``x * alpha``, the
Gaussian output ``x``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from galaxy_deconv_tpu_torch.nets import ResUNet, SubNet, XDenseUNet
from galaxy_deconv_tpu_torch.ops import fourier


def v_update_poisson(v_tilde, y, rho2, alpha):
    """The reference's Poisson v-update, kept verbatim for its weights: the
    quadratic root has the wrong sign, so it is not the prox of the Poisson
    NLL (see :func:`v_update_poisson_exact`)."""
    t1 = rho2 * v_tilde - alpha
    return 0.5 * (1.0 / rho2) * (-t1 + torch.sqrt(t1**2 + 4.0 * y * rho2))


def v_update_poisson_exact(v_tilde, y, rho2, alpha):
    """The exact prox of ``alpha*v - y*log(alpha*v)``: the positive root of
    ``rho2*v^2 + (alpha - rho2*v_tilde)*v - y = 0``, in the direct form for
    t1 > 0 and the conjugate form, free of cancellation, for t1 <= 0."""
    t1 = rho2 * v_tilde - alpha
    disc = torch.sqrt(t1**2 + 4.0 * y * rho2)
    return torch.where(t1 > 0, 0.5 * (1.0 / rho2) * (t1 + disc), 2.0 * y / (disc - t1).clamp_min(1e-30))


def v_update_gaussian(v_tilde, y, rho2):
    return (rho2 * v_tilde + y) / (1.0 + rho2)


def soft_threshold(z_tilde, lam, rho1):
    return torch.sign(z_tilde) * (z_tilde.abs() - lam / rho1).clamp_min(0.0)


def make_denoiser(denoiser: str, features: Sequence[int], dtype: torch.dtype) -> tuple[str, nn.Module]:
    """(attribute name, net) of the z-update network: ``"ResUNet"`` is a
    ResUNet of ``features``, anything else the XDenseUNet, as in the JAX
    package."""
    if denoiser == "ResUNet":
        return "resunet", ResUNet(features=features).to(dtype)
    return "xdense_unet", XDenseUNet(dtype=dtype)


def wiener_init(y: torch.Tensor, Ht: torch.Tensor, HtH: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The Wiener solve on y / alpha, clipped to [0, 1] (the reference's
    ``init_l2``); alpha is (B, 1, 1)."""
    x = fourier.irfft2(Ht * fourier.rfft2(y / alpha) / (HtH + 1.0 / alpha), y.shape[-2:])
    return x.clamp(0.0, 1.0)


def x_update_two_dual(z, u1, v, u2, H, Ht, HtH, rho1, rho2) -> torch.Tensor:
    """The shadowed ``X_Update``: denominator rho1 |H|^2 + rho2."""
    rhs = fourier.rfft2(rho1 * (z - u1) + rho2 * fourier.conv_fft(Ht, v - u2))
    return fourier.irfft2(rhs / (rho1 * HtH + rho2), z.shape[-2:])


class UnrolledADMM(nn.Module):
    """``forward(obs, psf, alpha)`` -> (B, H, W) float32.

    ``subnet=False`` learns ``rho1_iters`` and ``rho2_iters`` (ones at
    first); ``pnp=False`` replaces the denoiser by a soft-threshold with
    ``lam = softplus(lam_raw)`` (``lam_raw`` zero at first).  ``dtype`` is
    the nets' compute type.
    """

    def __init__(self, n_iters: int = 8, llh: str = "Poisson", denoiser: str = "ResUNet", pnp: bool = True,
                 subnet: bool = True, features: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_iters = n_iters
        self.llh = llh
        self.pnp = pnp
        self.dtype = dtype
        if subnet:
            self.subnet = SubNet(n_outputs=2 * n_iters, dtype=dtype)
        else:
            self.subnet = None
            self.rho1_iters = nn.Parameter(torch.empty(n_iters))
            self.rho2_iters = nn.Parameter(torch.empty(n_iters))
        if pnp:
            self.net_name, net = make_denoiser(denoiser, features, dtype)
            self.add_module(self.net_name, net)
        else:
            self.lam_raw = nn.Parameter(torch.empty(()))
        self.reset_scalars()

    def reset_scalars(self) -> None:
        """flax's initial values: rho1_iters, rho2_iters ones; lam_raw zero."""
        with torch.no_grad():
            if self.subnet is None:
                self.rho1_iters.fill_(1.0)
                self.rho2_iters.fill_(1.0)
            if not self.pnp:
                self.lam_raw.zero_()

    def _denoise(self, z: torch.Tensor, rho1: torch.Tensor) -> torch.Tensor:
        if not self.pnp:
            return soft_threshold(z, F.softplus(self.lam_raw), rho1)
        return getattr(self, self.net_name)(z[:, None].to(self.dtype))[:, 0].float()

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        B = obs.shape[0]
        alpha = alpha.reshape(B).float()[:, None, None]
        y = obs.float().clamp_min(0.0)
        H = fourier.psf_to_otf(psf)
        Ht, HtH = H.conj(), H.abs() ** 2

        if self.subnet is not None:
            rho_all = self.subnet(psf, alpha)
            rho1_iters, rho2_iters = rho_all[:, : self.n_iters], rho_all[:, self.n_iters :]
        else:
            rho1_iters = self.rho1_iters[None].expand(B, self.n_iters)
            rho2_iters = self.rho2_iters[None].expand(B, self.n_iters)

        x = wiener_init(y, Ht, HtH, alpha)
        z, v = x, y
        u1, u2 = torch.zeros_like(x), torch.zeros_like(y)
        for i in range(self.n_iters):
            rho1, rho2 = rho1_iters[:, i, None, None], rho2_iters[:, i, None, None]
            Hx = fourier.conv_fft(H, x)
            if self.llh == "Poisson":
                v = v_update_poisson(Hx + u2, y, rho2, alpha)
            else:
                v = v_update_gaussian(Hx + u2, y / alpha, rho2)
            z = self._denoise(x + u1, rho1)
            x = x_update_two_dual(z, u1, v, u2, H, Ht, HtH, rho1, rho2)
            u1 = u1 + x - z
            u2 = u2 + fourier.conv_fft(H, x) - v
        return (x * alpha if self.llh == "Poisson" else x).float()
