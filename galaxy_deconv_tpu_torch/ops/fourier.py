"""Fourier-domain helpers on the trailing two axes of (..., H, W) tensors.

Counterpart of ``galaxy_deconv_tpu/ops/fourier.py:44-202``.  Every image on
the path is real, so spectra are the ``rfft2`` half-spectrum, exactly as in
the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """fftshift over the trailing two (image) axes."""
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """ifftshift over the trailing two (image) axes."""
    return torch.fft.ifftshift(x, dim=(-2, -1))


def rfft2(x: torch.Tensor) -> torch.Tensor:
    """Real 2D FFT over the trailing two axes: (..., H, W) -> (..., H, W//2+1)."""
    return torch.fft.rfft2(x.float(), dim=(-2, -1))


def irfft2(X: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Inverse real 2D FFT over the trailing two axes with explicit output shape."""
    return torch.fft.irfft2(X, s=tuple(shape), dim=(-2, -1))


def pad_double(img: torch.Tensor) -> torch.Tensor:
    """Zero-pad (..., H, W) -> (..., 2H, 2W) with the image centred."""
    H, W = img.shape[-2], img.shape[-1]
    return F.pad(img, (W // 2, W // 2, H // 2, H // 2))


def crop_half(img: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pad_double`: centre-crop (..., 2H, 2W) -> (..., H, W)."""
    H, W = img.shape[-2], img.shape[-1]
    return img[..., H // 4 : 3 * H // 4, W // 4 : 3 * W // 4]


def pad_to_size_centered(ker: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Zero-pad a centred (..., kh, kw) kernel to a centred (..., H, W) canvas.

    The kernel's centre pixel (index ``k//2``) lands on the canvas centre
    pixel (index ``n//2``), so a following :func:`ifftshift2` rolls it to the
    origin.
    """
    H, W = shape
    kh, kw = ker.shape[-2], ker.shape[-1]
    top = H // 2 - kh // 2
    left = W // 2 - kw // 2
    return F.pad(ker, (left, W - kw - left, top, H - kh - top))


def otf_from_centered_psf(psf: torch.Tensor, shape: tuple[int, int] | None = None) -> torch.Tensor:
    """rfft-domain OTF of a *centred* PSF, optionally embedded into ``shape``.

    Rolls the centred PSF so its centre pixel sits at the origin (the
    circular-convolution convention), then takes ``rfft2``.  Returns
    complex64 with trailing shape ``(H, W//2+1)``.
    """
    if shape is not None and (psf.shape[-2], psf.shape[-1]) != tuple(shape):
        psf = pad_to_size_centered(psf, shape)
    return rfft2(ifftshift2(psf))


def psf_to_otf(psf: torch.Tensor, shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Alias for :func:`otf_from_centered_psf` (the reference's name)."""
    return otf_from_centered_psf(psf, shape)


def conv_fft(otf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Circular convolution of a real image batch with an rfft-domain OTF.

    ``otf`` has trailing shape (H, W//2+1) (from :func:`psf_to_otf`); ``x``
    has trailing shape (H, W).  Broadcasts over leading axes.
    """
    H, W = x.shape[-2], x.shape[-1]
    return irfft2(rfft2(x) * otf, (H, W))


def conv_fft_symm(psf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Convolution with reflection boundary handling, output aligned with
    ``x``: reflect-pad (..., H, W) by half its size, circularly convolve
    with the centred kernel ``psf`` (..., kh, kw), crop the centre back.
    The JAX docstring records how this differs from the reference's
    ``conv_kernel_symm``."""
    H, W = x.shape[-2], x.shape[-1]
    ph, pw = H // 2, W // 2
    # torch's reflect pad of the trailing two axes takes a 3- or 4-D tensor
    x_pad = F.pad(x.reshape(-1, 1, H, W), (pw, pw, ph, ph), mode="reflect").reshape(*x.shape[:-2], H + 2 * ph,
                                                                                  W + 2 * pw)
    otf = psf_to_otf(psf, (H + 2 * ph, W + 2 * pw))
    return conv_fft(otf, x_pad)[..., ph : ph + H, pw : pw + W]


def conv_fft_full(otf_full_arr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Circular convolution with a *full* complex OTF (legacy convention)."""
    return torch.fft.ifft2(torch.fft.fft2(x.float(), dim=(-2, -1)) * otf_full_arr, dim=(-2, -1)).real


@functools.lru_cache(maxsize=None)
def _laplacian_np() -> np.ndarray:
    return np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], dtype=np.float32)


def laplacian_kernel(device=None) -> torch.Tensor:
    """3x3 Laplacian stencil of the Tikhonov filter."""
    return torch.tensor(_laplacian_np(), device=device)


@functools.lru_cache(maxsize=None)
def _laplacian_quirk_np(shape: tuple[int, int]) -> np.ndarray:
    H, W = shape
    psf = np.zeros((H, W), np.float32)
    # the exact array the reference's quadrant swap produces for a 3x3 kernel
    # through torch index-assignment broadcasting (the centre=2 slices of a
    # 3x3 tensor broadcast into 2x2 corners)
    psf[0, W - 1] = 1.0
    psf[1, W - 1] = 1.0
    psf[H - 1, 0] = 1.0
    psf[H - 1, 1] = 1.0
    psf[H - 2, W - 1] = 1.0
    psf[H - 1, W - 2] = 1.0
    psf[H - 1, W - 1] = -4.0
    return psf


def laplacian_otf_reference_quirk(shape: tuple[int, int], device=None) -> torch.Tensor:
    """The reference's actual Laplacian OTF, quirk included: six +1 taps (sum
    2, so |L(0)|^2 = 4) where the exact stencil has four (sum 0).  It
    regularises the Tikhonov solve's DC mode, which the exact stencil leaves
    alone, and the trained Tikhonet/ShapeNet weights depend on it."""
    return rfft2(torch.tensor(_laplacian_quirk_np(tuple(shape)), device=device))
