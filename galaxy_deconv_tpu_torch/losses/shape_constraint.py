"""Shape-constraint loss: MSE + shearlet-projected moment constraints
(counterpart of ``galaxy_deconv_tpu/losses/shape_constraint.py``; reference
``utils/utils_train.py:286-304`` with the constants of ``utils/cadmos_lib.py``,
the CADMOS galaxy-shape constraint of Nammour et al. 2022):

    loss = MSE(out, gt)
           + gamma * sum_{i<6, j<S} mu_ij * (L1(out * psu_ij, gt * psu_ij))^2 / 2

where ``psu = Psi^*(U)`` are the six moment-constraint matrices U1..U6 (first-
and second-order coordinate monomials) convolved with the adjoint shearlet
bank, and ``mu`` per-filter weights.  The constants are computed once, in
numpy float64 at construction, exactly as the JAX package computes them (the
AlphaTransform bank when that package imports, else the built-in Meyer bank of
:mod:`galaxy_deconv_tpu_torch.losses.shearlets`; ``bank='dog'`` the isotropic
difference-of-Gaussians stand-in); the loss itself runs in torch on the
device of its inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from galaxy_deconv_tpu_torch.parallel.batch import batch_mean


def make_u(n: int, m: int) -> np.ndarray:
    """The six moment-constraint matrices U1..U6 (6, n, m).

    U1=i, U2=j, U3=1, U4=i^2+j^2, U5=i^2-j^2, U6=i*j — the generators of
    first- and second-order moments used by the CADMOS shape constraint.
    """
    i = np.arange(n, dtype=np.float64)[:, None] * np.ones((1, m))
    j = np.ones((n, 1)) * np.arange(m, dtype=np.float64)[None, :]
    return np.stack([i, j, np.ones((n, m)), i**2 + j**2, i**2 - j**2, i * j])


def _dog_filter_bank(n: int, m: int, n_scales: int) -> np.ndarray:
    """Isotropic difference-of-Gaussians bank (n_scales+1, n, m) — the
    built-in stand-in for the shearlet adjoint bank."""
    ys = np.arange(n) - n // 2
    xs = np.arange(m) - m // 2
    r2 = ys[:, None] ** 2 + xs[None, :] ** 2

    def gauss(sigma):
        g = np.exp(-r2 / (2 * sigma**2))
        return g / g.sum()

    sigmas = [0.5 * 2**s for s in range(n_scales + 1)]
    bank = [gauss(sigmas[0])]
    for s in range(n_scales):
        bank.append(gauss(sigmas[s + 1]) - gauss(sigmas[s]))
    return np.stack(bank)


def _convolve_same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'same'-mode linear convolution via zero-padded FFT (numpy, init-time only)."""
    n, m = img.shape
    kn, km = kernel.shape
    N, M = n + kn - 1, m + km - 1
    out = np.fft.irfft2(np.fft.rfft2(img, (N, M)) * np.fft.rfft2(kernel, (N, M)), (N, M))
    top, left = (kn - 1) // 2, (km - 1) // 2
    return out[top : top + n, left : left + m]


def compute_psu_mu(
    fov_pixels: int, n_shearlet: int = 2, bank: "Optional[np.ndarray | str]" = None
) -> tuple[np.ndarray, np.ndarray]:
    """Precompute psu = Psi^*(U) (6, S, H, W) and mu (6, S) weights.

    ``bank``: None/'shearlet' = built-in Meyer shearlet adjoints (default;
    AlphaTransform is used instead when importable), 'alpha' = require
    AlphaTransform, 'dog' = legacy isotropic stand-in, or an explicit
    (S, H, W) filter array.
    """
    U = make_u(fov_pixels, fov_pixels)
    if bank is None or isinstance(bank, str):
        kind = bank or "shearlet"
        adj = None
        if kind in ("shearlet", "alpha"):
            try:  # optional dependency, as in the reference
                from AlphaTransform import AlphaShearletTransform as AST  # type: ignore

                trafo = AST(fov_pixels, fov_pixels, [0.5] * n_shearlet, real=True, parseval=True, verbose=False)
                adj = np.array(
                    [_adjoint_filter(trafo, s, fov_pixels) for s in range(len(trafo.indices))]
                )
            except ImportError:
                if kind == "alpha":
                    raise
        if adj is None:
            if kind == "dog":
                adj = _dog_filter_bank(fov_pixels, fov_pixels, n_shearlet)
            else:
                from galaxy_deconv_tpu_torch.losses.shearlets import shearlet_spatial_filters

                adj = shearlet_spatial_filters(fov_pixels, fov_pixels, n_shearlet)
    else:
        adj = bank
    adj = np.stack([f / (np.linalg.norm(f) + 1e-12) for f in adj])
    psu = np.stack([np.stack([_convolve_same(u, f) for f in adj]) for u in U])  # (6, S, H, W)

    n = psu.shape[-1]
    norms = np.linalg.norm(psu.reshape(*psu.shape[:2], -1), axis=-1)
    mu = np.where(np.isclose(norms, 0.0), 0.0, n / np.maximum(norms, 1e-12) ** 2)
    mu = n * mu / mu.size
    return psu.astype(np.float32), mu.astype(np.float32)


def _adjoint_filter(trafo, scale: int, fov: int) -> np.ndarray:
    coeff = np.zeros((len(trafo.indices), fov, fov))
    coeff[scale, fov // 2, fov // 2] = 1.0
    return np.real(trafo.adjoint_transform(coeff, do_norm=False))


class ShapeConstraint:
    """MSE + gamma * weighted squared-L1 moment constraints, called as
    ``loss(output, target)`` ((B, H, W) each; the trainers pass (gt, rec))."""

    def __init__(
        self,
        fov_pixels: int = 48,
        gamma: float = 1.0,
        n_shearlet: int = 2,
        psu: Optional[np.ndarray] = None,
        mu: Optional[np.ndarray] = None,
        bank: "Optional[np.ndarray | str]" = None,
    ):
        if psu is None or mu is None:
            psu, mu = compute_psu_mu(fov_pixels, n_shearlet, bank=bank)
        self.gamma = gamma
        self.psu = torch.as_tensor(np.asarray(psu, np.float32))  # (6, S, H, W)
        self.mu = torch.as_tensor(np.asarray(mu, np.float32))  # (6, S)
        self._on = {}  # the constants on each device they were used on

    def _constants(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if device not in self._on:
            self._on[device] = (self.psu.to(device), self.mu.to(device))
        return self._on[device]

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        psu, mu = self._constants(output.device)
        loss = ((output - target) ** 2).mean()
        # (B, 6, S, H, W) products, formed as the JAX package forms them; L1
        # over batch and pixels per constraint, squared, mu-weighted, halved
        diff = output[:, None, None] * psu[None] - target[:, None, None] * psu[None]
        # over the global batch inside a data-parallel step: the square of a batch mean is not a mean of
        # per-sample terms, so averaging the ranks' losses alone would not give the global loss
        l1 = batch_mean(diff.abs().mean(dim=(0, -2, -1)))  # (6, S)
        return loss + self.gamma * (mu * l1**2).sum() / 2.0
