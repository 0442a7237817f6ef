"""Cone-adapted discrete shearlet filter bank (Meyer-type, Parseval): a numpy
copy of ``galaxy_deconv_tpu/losses/shearlets.py``, the same construction in
the same float64 arithmetic (this package imports nothing of the JAX one).

The reference's ShapeConstraint builds its ``psu``/``mu`` constants from the
``AlphaTransform`` package (``utils/cadmos_lib.py:76-91``):
``AST(w, h, [0.5]*n_scales, real=True, parseval=True)``: classical shearlets
(alpha = 0.5, parabolic scaling), real filters, a pointwise-Parseval system.
That package is not installable, so this module builds the same kind of bank
from its definition (cone-adapted shearlets with Meyer windows):

* the Meyer polynomial nu(x) = x^4(35 - 84x + 70x^2 - 20x^3) builds the
  radial dyadic windows W_j and the angular window V;
* scale j holds 2 * (2 k_j + 1) directional filters (k_j = ceil(2^{j/2})
  shears on each of the horizontal and vertical frequency cones);
* one isotropic low-pass completes the system;
* ``real=True``: each mask is made even, so the spatial filters are real;
* ``parseval=True``: the system is normalised pointwise in Fourier so that
  sum_s |psi_s(xi)|^2 = 1 exactly, a tight frame by construction.
"""

from __future__ import annotations

import functools

import numpy as np


def _meyer_nu(x: np.ndarray) -> np.ndarray:
    """Meyer auxiliary function: 0 for x<=0, 1 for x>=1, C^3 ramp between."""
    x = np.clip(x, 0.0, 1.0)
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def _radial_window(rho: np.ndarray, j: int, n_scales: int) -> np.ndarray:
    """Dyadic Meyer band-pass for scale j on normalized radius rho in [0, 1].

    Band j (j = 0 .. n_scales-1) peaks at rho_j = 2^{-(n_scales-1-j)} * 0.5,
    rising from rho_j/2 and falling to 2 rho_j (the outermost band stays at
    1 through the Nyquist corner so the partition covers all frequencies).
    """
    peak = 0.5 * 2.0 ** (-(n_scales - 1 - j))
    lo, hi = peak / 2.0, min(2.0 * peak, 1.0)
    up = _meyer_nu((rho - lo) / (peak - lo))
    if j == n_scales - 1:
        down = 1.0  # outermost band covers through Nyquist (incl. corners)
    else:
        down = 1.0 - _meyer_nu((rho - peak) / (hi - peak))
    return np.sqrt(np.clip(up * down, 0.0, 1.0))


def _angular_window(t: np.ndarray) -> np.ndarray:
    """Smooth bump on [-1, 1] in the shear variable t (value 1 at t=0)."""
    return np.sqrt(np.clip(_meyer_nu(1.0 - np.abs(t)) , 0.0, 1.0))


@functools.lru_cache(maxsize=None)
def shearlet_bank_fourier(
    height: int, width: int, n_scales: int = 2
) -> np.ndarray:
    """Fourier masks of the real, Parseval shearlet system.

    Returns (n_filters, H, W) real arrays on the *unshifted* DFT grid
    (DC at [0, 0]); n_filters = 1 + sum_j 2 (2 k_j + 1), k_j = ceil(2^{j/2}).
    sum over filters of mask^2 == 1 everywhere (asserted in tests).
    """
    fy = np.fft.fftfreq(height)[:, None] * np.ones((1, width))
    fx = np.ones((height, 1)) * np.fft.fftfreq(width)[None, :]
    rho = np.sqrt(fy**2 + fx**2) / 0.5  # radius in units of the axis Nyquist
    masks = []

    # low-pass: complement of the band-pass ramps (exact by later projection)
    lo_peak = 0.5 * 2.0 ** (-(n_scales - 1)) / 2.0
    lowpass = np.sqrt(np.clip(1.0 - _meyer_nu(rho / lo_peak - 1.0), 0.0, 1.0))
    masks.append(lowpass)

    eps = 1e-12
    for j in range(n_scales):
        rad = _radial_window(rho, j, n_scales)
        k_max = int(np.ceil(2.0 ** (j / 2.0)))
        n_dir = 2 * k_max + 1
        # horizontal cone: |fx| >= |fy|, shear t = fy/fx; vertical: swapped
        for cone in ("h", "v"):
            a, b = (fx, fy) if cone == "h" else (fy, fx)
            on_cone = np.abs(a) >= np.abs(b) - eps
            t = np.where(np.abs(a) > eps, b / np.where(np.abs(a) > eps, a, 1.0), 0.0)
            for k in range(-k_max, k_max + 1):
                # windows centered at shear k/k_max with unit spacing in k
                ang = _angular_window(t * k_max - k) if k_max else _angular_window(t)
                mask = rad * ang * on_cone
                # real=True: symmetrize (frequency masks are already even
                # under (fy,fx) -> (-fy,-fx) on this grid by construction
                # of rho/t, so spatial filters come out real)
                masks.append(mask)

    bank = np.stack(masks)
    # real=True: enforce exact evenness m(-k) = m(k).  The construction is
    # even everywhere except the self-mirrored Nyquist row/column of the
    # even-sized DFT grid (where the shear variable t flips sign);
    # symmetrize in quadrature so spatial filters are exactly real.
    flipped = np.roll(np.roll(bank[:, ::-1, ::-1], 1, axis=-2), 1, axis=-1)
    bank = np.sqrt(0.5 * (bank**2 + flipped**2))
    # parseval=True: pointwise normalization => exact tight frame
    total = np.sqrt(np.maximum((bank**2).sum(axis=0), 1e-30))
    bank = bank / total
    return bank.astype(np.float64)


def shearlet_spatial_filters(height: int, width: int, n_scales: int = 2) -> np.ndarray:
    """Real-space synthesis (= adjoint, for a Parseval frame) filters,
    centered at (H//2, W//2): the counterpart of the reference's
    ``get_adjoint_coeff`` (utils/cadmos_lib.py:112-126)."""
    bank = shearlet_bank_fourier(height, width, n_scales)
    filts = np.fft.fftshift(
        np.fft.ifft2(bank, axes=(-2, -1)).real, axes=(-2, -1)
    )
    return filts


def analysis(img: np.ndarray, n_scales: int = 2) -> np.ndarray:
    """Shearlet analysis coefficients (n_filters, H, W) of a 2D image."""
    bank = shearlet_bank_fourier(img.shape[0], img.shape[1], n_scales)
    F = np.fft.fft2(img)
    return np.fft.ifft2(F[None] * bank, axes=(-2, -1)).real


def synthesis(coeff: np.ndarray, n_scales: int = 2) -> np.ndarray:
    """Adjoint/synthesis: for this Parseval system, synthesis(analysis(x)) == x."""
    bank = shearlet_bank_fourier(coeff.shape[1], coeff.shape[2], n_scales)
    F = (np.fft.fft2(coeff, axes=(-2, -1)) * bank).sum(axis=0)
    return np.fft.ifft2(F).real
