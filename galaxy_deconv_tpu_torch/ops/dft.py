"""Matmul-DFT spectra for the padded-domain ADMM solves.

Counterpart of ``galaxy_deconv_tpu/ops/dft.py:57-136``.  Zero-padding to
2H x 2W, the ifftshift/fftshift and the crop around each transform are
linear maps, so they fold into small dense DFT matrices:

    spec_rfft2_padded(x)        == rfft2(ifftshift2(pad_double(x)))
    spec_irfft2_cropped(S, hw)  == crop_half(fftshift2(irfft2(S, 2*hw)))

The matrices are built once in numpy and cached; the products are
``torch.matmul`` in full fp32 (TF32 off for the duration of the call), as the
JAX package runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _plan(n: int, rfft: bool):
    """Forward-transform matrices for one axis: image length n -> canvas 2n.

    Returns (Ar, Ai): real/imag of A[f, r] = exp(-2i*pi*f*(r - n/2)/(2n)),
    f over the full canvas (2n) or the rfft half (n+1).
    """
    canvas = 2 * n
    f = np.arange(n + 1 if rfft else canvas)
    r = np.arange(n)
    ang = -2.0 * np.pi * np.outer(f, (r - n // 2)) / canvas
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _iplan(n: int, rfft: bool):
    """Inverse-transform matrices for one axis: canvas 2n -> image length n.

    Returns (Br, Bi): real/imag of B[r, f] = w_f * exp(2i*pi*f*(r - n/2)/(2n)) / (2n)
    with rfft Hermitian weights w_f (1 at f = 0 and f = n, 2 between) when
    ``rfft``, else w_f = 1 over the full canvas.
    """
    canvas = 2 * n
    f = np.arange(n + 1 if rfft else canvas)
    r = np.arange(n)
    ang = 2.0 * np.pi * np.outer(r - n // 2, f) / canvas
    w = np.ones_like(f, np.float64)
    if rfft:
        w[1:n] = 2.0
    scale = w / canvas
    return ((np.cos(ang) * scale).astype(np.float32),
            (np.sin(ang) * scale).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _on_device(plan, n: int, rfft: bool, device: torch.device):
    return tuple(torch.from_numpy(m).to(device) for m in plan(n, rfft))


@contextlib.contextmanager
def _full_fp32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def spec_rfft2_padded(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) real -> (..., 2H, W+1) complex half-spectrum."""
    h, w = x.shape[-2], x.shape[-1]
    Ahr, Ahi = _on_device(_plan, h, False, x.device)  # (2H, H)
    Awr, Awi = _on_device(_plan, w, True, x.device)   # (W+1, W)
    x = x.float()
    with _full_fp32_matmul():
        ur = Ahr @ x
        ui = Ahi @ x
        sr = ur @ Awr.T - ui @ Awi.T
        si = ur @ Awi.T + ui @ Awr.T
    return torch.complex(sr, si)


def spec_irfft2_cropped(S: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(..., 2H, W+1) complex half-spectrum -> (..., H, W) real; ``shape`` is (H, W)."""
    h, w = shape
    Bhr, Bhi = _on_device(_iplan, h, False, S.device)  # (H, 2H)
    Bwr, Bwi = _on_device(_iplan, w, True, S.device)   # (W, W+1)
    sr, si = S.real, S.imag
    with _full_fp32_matmul():
        tr = Bhr @ sr - Bhi @ si
        ti = Bhr @ si + Bhi @ sr
        return tr @ Bwr.T - ti @ Bwi.T
