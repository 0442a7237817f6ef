"""Fourier-domain helpers on the trailing two axes of (..., H, W) tensors.

Counterpart of ``galaxy_deconv_tpu/ops/fourier.py:44-130`` (the subset the
flagship and the baseline solvers use).  Every image on the path is real, so spectra are the
``rfft2`` half-spectrum, exactly as in the JAX package.
"""

from __future__ import annotations

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
