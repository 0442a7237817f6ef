"""The reference's FPFS shear metric in plain numpy: a copy of
``galaxy_deconv_tpu/metrics/fpfs_numpy.py``, the same arithmetic in float64
(this package imports nothing of the JAX one).

The reference measures shear with the ``fpfs`` package (pinned 3.0.2) through
``estimate_shear`` (``utils/utils_test.py:33-49``)::

    task = fpfs.image.measure_source(psf, noiFit=None, sigma_arcsec=0.6,
                                     pix_scale=0.2)
    mms  = task.measure(obs - obs.min())
    ells = fpfs.catalog.fpfsM2E(mms, const=1, noirev=False)
    g_i  = ells['fpfs_e%d'][0] / ells['fpfs_R1E'][0]      # R1E for BOTH
    g    = hypot(g_1, g_2)

That package is not installable, so this module re-derives the measurement
from the FPFS papers (Li et al. 2018; Li, Mandelbaum et al. 2022): linear
polar-shapelet moments M00, M22 and M40 of the PSF-deconvolved Fourier
transform (zeroed beyond fpfs's ``get_klim`` band limit), then

    e_i = M22_i / (M00 + C),  R1E = (s0 - s4)/sqrt(2) + sqrt(2) e_1^2,

with both components divided by R1E, the reference's quirk.  A centred delta
"PSF" measures already-deconvolved stamps, as the reference's ``delta_2D``.
The batched device version is :mod:`galaxy_deconv_tpu_torch.metrics.shear`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "delta_psf",
    "fpfs_moments_numpy",
    "estimate_shear_numpy",
]


def delta_psf(h: int = 48, w: int = 48) -> np.ndarray:
    """Centered delta 'PSF' (reference ``delta_2D``, utils/utils_test.py:27-30)."""
    d = np.zeros((h, w), np.float64)
    d[h // 2, w // 2] = 1.0
    return d


def _basis(shape: tuple[int, int], sigma_arcsec: float, pix_scale: float):
    """chi_00*, chi_22*, chi_40* on the (full) DFT grid."""
    H, W = shape
    ky = 2.0 * np.pi * np.fft.fftfreq(H, d=pix_scale)
    kx = 2.0 * np.pi * np.fft.fftfreq(W, d=pix_scale)
    KY, KX = np.meshgrid(ky, kx, indexing="ij")
    x = (KY**2 + KX**2) * sigma_arcsec**2
    # polar angle measured from the k_y axis: the axis convention under
    # which the estimator returns the *applied* shear with the standard
    # real-space sign (verified by the metamorphic tests; the (KY, KX)
    # ordering would flip g1).
    phi = np.arctan2(KX, KY)
    w = np.exp(-x / 2.0)
    chi00 = w
    chi22 = (x / np.sqrt(2.0)) * w * np.exp(-2j * phi)  # conj(chi_22)
    chi40 = ((x**2 - 4.0 * x + 2.0) / 2.0) * w
    return chi00, chi22, chi40


def fpfs_moments_numpy(
    gal: np.ndarray,
    psf: np.ndarray | None = None,
    sigma_arcsec: float = 0.6,
    pix_scale: float = 0.2,
) -> dict[str, float]:
    """FPFS shapelet moments M00, M22c, M22s, M40 of one 2D stamp.

    ``psf=None`` uses the centered delta (the reference's convention for
    post-deconvolution images).  The galaxy stamp is used as-is — callers
    replicate the reference's ``obs - obs.min()`` background subtraction.
    """
    gal = np.asarray(gal, np.float64)
    H, W = gal.shape
    if psf is None:
        psf = delta_psf(H, W)
    psf = np.asarray(psf, np.float64)

    # linear (fpfs 3.x) measurement: deconvolved Fourier TRANSFORM, not the
    # 2018 power function — see metrics/shear.py's module docstring for why
    # (noise-rectification vs the reference's committed low-SNR results)
    F = np.fft.fft2(gal)
    P = np.fft.fft2(psf)
    Pmag = np.abs(P)
    safe = Pmag > 1e-12 * Pmag.max()
    G = np.where(safe, F / np.where(safe, P, 1.0), 0.0)

    # fpfs get_klim band limit (inert for a delta PSF; rarely binds here)
    sigma_f = H * pix_scale / (2.0 * np.pi * sigma_arcsec)
    Ppow = Pmag**2 / Pmag.max() ** 2
    klim = H // 2 - 1
    for dist in range(H // 5, H // 2 - 1):
        ave = np.exp(-(dist**2) / (2.0 * sigma_f**2)) / max(
            0.5 * (Ppow[dist, 0] + Ppow[0, dist]), 1e-300
        )
        if ave <= 1e-20:
            klim = dist
            break
    gy = np.abs(np.fft.fftfreq(H) * H)
    gx = np.abs(np.fft.fftfreq(W) * W)
    rgrid = np.hypot(*np.meshgrid(gy, gx, indexing="ij"))
    D = np.where(rgrid <= klim, G, 0.0).real

    chi00, chi22, chi40 = _basis((H, W), sigma_arcsec, pix_scale)
    m00 = float(np.sum(D * chi00).real)
    m22 = complex(np.sum(D * chi22))
    m40 = float(np.sum(D * chi40).real)
    return {"M00": m00, "M22c": m22.real, "M22s": m22.imag, "M40": m40}


def estimate_shear_numpy(
    obs: np.ndarray,
    psf: np.ndarray | None = None,
    sigma_arcsec: float = 0.6,
    pix_scale: float = 0.2,
    const: float = 1.0,
    subtract_min: bool = True,
) -> tuple[float, float, float]:
    """(g1, g2, |g|) of one stamp — the reference's ``estimate_shear``
    (utils/utils_test.py:33-49) without the fpfs package.

    ``subtract_min=True`` replicates ``task.measure(obs - obs.min())``.
    Both components are divided by R1E (reference quirk, :45-47).
    """
    obs = np.asarray(obs, np.float64)
    if subtract_min:
        obs = obs - obs.min()
    m = fpfs_moments_numpy(obs, psf, sigma_arcsec, pix_scale)
    denom = m["M00"] + const
    e1 = m["M22c"] / denom
    e2 = m["M22s"] / denom
    s0 = m["M00"] / denom
    s4 = m["M40"] / denom
    r1e = (s0 - s4) / np.sqrt(2.0) + np.sqrt(2.0) * e1 * e1
    g1 = e1 / r1e
    g2 = e2 / r1e
    return float(g1), float(g2), float(np.hypot(g1, g2))
