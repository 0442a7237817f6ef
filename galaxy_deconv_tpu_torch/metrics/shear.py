"""Batched FPFS shear estimation (linear shapelet estimator).

Counterpart of ``galaxy_deconv_tpu/metrics/shear.py:68-205``; see that module
for the derivation.  In short, with G the (optionally PSF-deconvolved) Fourier
transform of the background-subtracted stamp, the moments are

    M00 = Re sum G chi00*,  M22 = sum G chi22*,  M40 = Re sum G chi40*

over the rfft half-spectrum with Hermitian multiplicities, and
``estimate_shear`` returns g_i = e_i / R1E with e_i = M22{c,s} / (M00 + C),
R1E = (s0 - s4)/sqrt(2) + sqrt(2) e1^2 (R1E for both components, the
reference's convention).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

KLIM_THRES = 1e-20  # fpfs get_klim threshold


def delta_psf(h: int = 48, w: int = 48) -> np.ndarray:
    """Centred delta 'PSF' used when measuring already-deconvolved images."""
    d = np.zeros((h, w), np.float32)
    d[h // 2, w // 2] = 1.0
    return d


@functools.lru_cache(maxsize=None)
def _basis_np(shape: tuple[int, int], sigma_arcsec: float, pix_scale: float):
    """Half-spectrum chi_00*, chi_22*, chi_40* with Hermitian multiplicity,
    plus the grid radius (in full-grid pixels) used for the klim cut."""
    H, W = shape
    ky = 2.0 * np.pi * np.fft.fftfreq(H, d=pix_scale)
    kx = 2.0 * np.pi * np.fft.rfftfreq(W, d=pix_scale)
    KY, KX = np.meshgrid(ky, kx, indexing="ij")
    x = (KY**2 + KX**2) * sigma_arcsec**2
    phi = np.arctan2(KX, KY)  # angle from the k_y axis
    w = np.exp(-x / 2.0)
    mult = np.full((H, W // 2 + 1), 2.0)
    mult[:, 0] = 1.0
    if W % 2 == 0:
        mult[:, -1] = 1.0
    chi00 = w * mult
    chi22 = (x / np.sqrt(2.0)) * w * np.exp(-2j * phi) * mult
    chi40 = ((x**2 - 4.0 * x + 2.0) / 2.0) * w * mult
    gy = np.abs(np.fft.fftfreq(H) * H)
    gx = np.abs(np.fft.rfftfreq(W) * W)
    rgrid = np.hypot(*np.meshgrid(gy, gx, indexing="ij"))
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.rfftfreq(W)[None, :]
    # the transform of a delta at (H//2, W//2) is e^{-2 pi i (fy H//2 + fx W//2)};
    # multiplying by its inverse re-centres the galaxy's transform
    centre = np.exp(2j * np.pi * (fy * (H // 2) + fx * (W // 2)))
    return (chi00.astype(np.float32), chi22.astype(np.complex64), chi40.astype(np.float32),
            rgrid.astype(np.float32), centre.astype(np.complex64))


@functools.lru_cache(maxsize=None)
def _basis(shape: tuple[int, int], sigma_arcsec: float, pix_scale: float, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _basis_np(shape, sigma_arcsec, pix_scale))


def _klim(Ppow: torch.Tensor, sigma_f: float, H: int) -> torch.Tensor:
    """fpfs ``get_klim``: smallest axis distance in [H//5, H//2-1) where the
    shapelet Gaussian over the (max-normalised) PSF power drops below
    KLIM_THRES, else H//2-1.  ``Ppow``: (B, H, W//2+1).  Returns (B,) radii."""
    dists = torch.arange(H // 5, H // 2 - 1, device=Ppow.device)
    gauss = torch.exp(-(dists.float() ** 2) / (2.0 * sigma_f**2))
    row = Ppow[:, dists, 0]
    col = Ppow[:, 0, dists]
    ave = gauss[None, :] / torch.clamp_min(0.5 * (row + col), 1e-300)
    below = ave <= KLIM_THRES
    first = torch.argmax(below.int(), dim=1)
    found = below.any(dim=1)
    return torch.where(found, dists[first], H // 2 - 1).float()


def fpfs_moments(images: torch.Tensor, psf: torch.Tensor | None = None, sigma_arcsec: float = 0.6,
                 pix_scale: float = 0.2, deconv_psf: bool = False) -> dict[str, torch.Tensor]:
    """FPFS shapelet moments of (B, H, W) stamps centred at (H//2, W//2).

    With ``deconv_psf=True`` the transform of ``psf`` (B, H, W) deconvolves
    the galaxy's, cut at the fpfs klim band limit; otherwise the centred
    delta applies, whose transform is a pure centring phase.
    """
    B, H, W = images.shape
    images = images.float()
    images = images - images.amin(dim=(-2, -1), keepdim=True)  # reference: obs - obs.min()
    F = torch.fft.rfft2(images, dim=(-2, -1))
    chi00, chi22, chi40, rgrid, centre = _basis((H, W), float(sigma_arcsec), float(pix_scale), images.device)
    if deconv_psf:
        P = torch.fft.rfft2(psf.float(), dim=(-2, -1))
        Pmag = P.abs()
        Pmax = Pmag.amax(dim=(-2, -1), keepdim=True)
        # guard only against numerically dead modes; the Gaussian window
        # suppresses everything out there anyway
        safe = Pmag > 1e-12 * Pmax
        G = torch.where(safe, F / torch.where(safe, P, torch.ones_like(P)), torch.zeros_like(F))
        sigma_f = H * pix_scale / (2.0 * math.pi * sigma_arcsec)
        klim = _klim(Pmag**2 / Pmax**2, sigma_f, H)
        G = torch.where(rgrid[None] <= klim[:, None, None], G, torch.zeros_like(G))
    else:
        G = F * centre
    D = G.real
    m22 = (D * chi22).sum(dim=(-2, -1))
    return {
        "M00": (D * chi00).sum(dim=(-2, -1)),
        "M22c": m22.real,
        "M22s": m22.imag,
        "M40": (D * chi40).sum(dim=(-2, -1)),
    }


def estimate_shear(images: torch.Tensor, psf: torch.Tensor | None = None, sigma_arcsec: float = 0.6,
                   pix_scale: float = 0.2, deconv_psf: bool = False, const: float = 1.0) -> torch.Tensor:
    """Batched (g1, g2, |g|) estimates: (B, H, W) -> (B, 3)."""
    m = fpfs_moments(images, psf, sigma_arcsec, pix_scale, deconv_psf)
    denom = m["M00"] + const
    e1 = m["M22c"] / denom
    e2 = m["M22s"] / denom
    s0 = m["M00"] / denom
    s4 = m["M40"] / denom
    r1e = (s0 - s4) / math.sqrt(2.0) + math.sqrt(2.0) * e1 * e1
    g1 = e1 / r1e
    g2 = e2 / r1e
    return torch.stack([g1, g2, torch.sqrt(g1**2 + g2**2)], dim=-1)
