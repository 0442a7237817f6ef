"""Classical-deblurring utilities (counterpart of ``galaxy_deconv_tpu/ops/deblur.py``,
the reference's legacy NumPy toolbox ``utils/utils_deblur.py``), on tensors.

Synthetic blur kernels (:func:`gauss_kernel`, :func:`disk`), the L1
soft-threshold prox (:func:`shrinkage`), periodic forward-difference TV
gradients and their adjoint (:func:`tv_grad`, :func:`tv_grad_adjoint`), the
gradient-selection mask (:func:`gradient_mask`), blind kernel estimation from
a sharp/blurred pair (:func:`estimate_kernel`) and Bayer mosaic helpers
(:func:`rgb_to_bayer`, :func:`rggb_to_rgb`).

The JAX package's departures from the reference are kept:

* the kernels' grid is the symmetric pixel-centre grid
  ``arange(size) - (size - 1) / 2``, where the reference's
  ``linspace(-(size-1)/2, size/2, size)`` is off centre (and ``disk``'s
  takes linspace's default 50 points whatever ``size``);
* ``gradient_mask`` rectifies with the elementwise ``maximum``, where the
  reference's ``np.max(arr, 0)`` reduces over axis 0;
* ``estimate_kernel`` is the working form of the reference's ``k_ifft``,
  which calls a two-argument ``crop`` that was commented out.
"""

from __future__ import annotations

import torch

__all__ = [
    "gauss_kernel",
    "disk",
    "shrinkage",
    "tv_grad",
    "tv_grad_adjoint",
    "gradient_mask",
    "estimate_kernel",
    "rgb_to_bayer",
    "rggb_to_rgb",
]


def _pixel_grid(size: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    return xx, yy


def gauss_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    """Normalised isotropic Gaussian blur kernel on a ``size`` x ``size`` grid."""
    xx, yy = _pixel_grid(size, device)
    k = torch.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return k / k.sum()


def disk(size: int, r: float, device=None) -> torch.Tensor:
    """Normalised circular (defocus) kernel of radius ``r`` pixels.  A radius
    that selects no grid point falls back to the pixel nearest the centre (a
    delta, off centre for an even ``size``)."""
    xx, yy = _pixel_grid(size, device)
    r2 = xx**2 + yy**2
    k = (r2 < r**2).to(torch.float32)
    delta = (r2 == r2.min()).to(torch.float32)
    k = torch.where(k.sum() > 0, k, delta)
    return k / k.sum()


def shrinkage(z: torch.Tensor, beta) -> torch.Tensor:
    """L1 soft threshold: sign(z) * max(|z| - beta, 0), written as the
    reference writes it, clip(z - beta, 0, inf) + clip(z + beta, -inf, 0)."""
    return torch.clamp(z - beta, min=0.0) + torch.clamp(z + beta, max=0.0)


def tv_grad(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Periodic forward differences (du/dx, du/dy) on the last two axes."""
    return torch.roll(u, -1, dims=-1) - u, torch.roll(u, -1, dims=-2) - u


def tv_grad_adjoint(dux: torch.Tensor, duy: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`tv_grad` (the negative periodic divergence):
    <D u, p> = <u, D* p>."""
    return (torch.roll(dux, 1, dims=-1) - dux) + (torch.roll(duy, 1, dims=-2) - duy)


def _box_blur5(x: torch.Tensor) -> torch.Tensor:
    """5x5 mean filter with zero padding, the reference's
    ``convolve2d(x, ones((5, 5)) / 25, mode='same')``, by summed-area tables."""
    c = torch.nn.functional.pad(x, (2, 2, 2, 2)).cumsum(-1).cumsum(-2)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))
    H, W = x.shape[-2], x.shape[-1]
    win = (c[..., 5:, 5:][..., :H, :W] - c[..., 5:, :-5][..., :H, :W]
           - c[..., :-5, 5:][..., :H, :W] + c[..., :-5, :-5][..., :H, :W])
    return win / 25.0


def gradient_mask(dx: torch.Tensor, dy: torch.Tensor, tau_s: float = 0.1, tau_r: float = 0.1):
    """Salient, locally coherent gradients for kernel estimation (reference
    ``Mask``): the coherence R = |box(Dx), box(Dy)| / (box(|D|) + 0.5);
    gradients kept in proportion to max(max(R - tau_r, 0) |D| - tau_s, 0).
    Returns (dx * w, dy * w, max(R - tau_r, 0))."""
    dmag = torch.sqrt(dx**2 + dy**2)
    a, b, c = _box_blur5(dx), _box_blur5(dy), _box_blur5(dmag)
    coherence = torch.sqrt(a**2 + b**2) / (c + 0.5)
    m = torch.clamp(coherence - tau_r, min=0.0)
    w = torch.clamp(m * dmag - tau_s, min=0.0)
    return dx * w, dy * w, m


def estimate_kernel(x_sharp: torch.Tensor, y_blur: torch.Tensor, lambda_l2: float = 1e-2,
                    ksize: int = 25) -> torch.Tensor:
    """The blur kernel relating a sharp/blurred pair, by the gradient-domain
    regularised Wiener solve argmin_k ||D(x) * k - D(y)||^2 + lambda_l2 ||k||^2,
    centre-cropped to ``ksize`` (the zero lag at (ksize // 2, ksize // 2)),
    rectified and normalised."""
    dx1, dx2, _ = gradient_mask(*tv_grad(x_sharp))
    dy1, dy2, _ = gradient_mask(*tv_grad(y_blur))
    fft2 = torch.fft.fft2
    Fx1, Fx2 = fft2(dx1), fft2(dx2)
    num = torch.conj(Fx1) * fft2(dy1) + torch.conj(Fx2) * fft2(dy2)
    den = Fx1.abs() ** 2 + Fx2.abs() ** 2 + lambda_l2
    k = torch.fft.ifftshift(torch.fft.ifft2(num / den), dim=(-2, -1)).real
    H, W = k.shape[-2], k.shape[-1]
    i1, j1 = H // 2 - ksize // 2, W // 2 - ksize // 2
    k = torch.clamp(k[..., i1:i1 + ksize, j1:j1 + ksize], min=0.0)
    return k / torch.clamp(k.sum(dim=(-2, -1), keepdim=True), min=1e-12)


def rgb_to_bayer(x: torch.Tensor) -> torch.Tensor:
    """Mosaic an (H, W, 3) RGB image to a (2H, 2W) RGGB Bayer pattern."""
    H, W, _ = x.shape
    out = x.new_zeros((2 * H, 2 * W))
    out[0::2, 0::2] = x[:, :, 0]
    out[0::2, 1::2] = x[:, :, 1]
    out[1::2, 0::2] = x[:, :, 1]
    out[1::2, 1::2] = x[:, :, 2]
    return out


def rggb_to_rgb(planes, switch_rgb: bool = False) -> torch.Tensor:
    """Demosaic four (H, W) RGGB planes to (H, W, 3), averaging the two greens."""
    rgb = torch.stack([planes[0], (planes[1] + planes[2]) * 0.5, planes[3]], dim=-1)
    return torch.flip(rgb, dims=(-1,)) if switch_rgb else rgb
