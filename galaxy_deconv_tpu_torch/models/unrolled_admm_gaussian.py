"""Unrolled Plug-and-Play ADMM with Gaussian likelihood, the flagship solver.

Counterpart of ``galaxy_deconv_tpu/models/unrolled_admm_gaussian.py:39-156``.
Per forward pass on (B, 48, 48) stamps:

1. spectra:  Y = F(pad2(y)), Ht = conj(F(pad2(psf))), HtH = |H|^2 at 2H x 2W,
2. schedule: per-iteration rho from SubNet(psf, alpha), or a learnable
             vector when ``subnet=False``,
3. init:     Wiener solve z0,
4. n_iters unrolled iterations of the x-update (pointwise solve through the
   CUDA kernel of ``ops/x_update.py``), the ResUNet z-update and the dual
   update,
5. the final z, or the (x, z, u, rho) traces when ``analysis=True``.

The spectra stay float32; ``dtype`` sets the ResUNet's and SubNet's compute
type (bfloat16 as ``bench.py`` runs them by default).  As in flax, the
SubNet's BatchNorm keeps float32 statistics and parameters in every dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from galaxy_deconv_tpu_torch.nets import ResUNet, SubNet
from galaxy_deconv_tpu_torch.ops import dft, fourier
from galaxy_deconv_tpu_torch.ops.x_update import x_update_solve

FFT_IMPLS = ("auto", "fft", "matmul")


def _spec_fns(impl: str):
    """The padded-spectrum transform pair: ``"fft"`` is torch.fft, ``"matmul"``
    the DFT matrices of ``ops/dft.py``.  ``"auto"`` is ``"fft"`` on every
    device: the TPU's choice of matmul is not carried over unmeasured."""
    if impl not in FFT_IMPLS:
        raise ValueError(f"fft_impl must be one of {FFT_IMPLS}, got {impl!r}")
    if impl == "matmul":
        return dft.spec_rfft2_padded, dft.spec_irfft2_cropped

    def fwd(x):
        return fourier.rfft2(fourier.ifftshift2(fourier.pad_double(x)))

    def inv(S, shape):
        padded = (2 * shape[0], 2 * shape[1])
        return fourier.crop_half(fourier.fftshift2(fourier.irfft2(S, padded)))

    return fwd, inv


def gaussian_spectra(y: torch.Tensor, psf: torch.Tensor, impl: str = "auto"):
    """Padded-domain spectra for the Gaussian ADMM: Y, Ht, |H|^2 at (2H, 2W)."""
    fwd, _ = _spec_fns(impl)
    Y = fwd(y)
    H = fwd(psf)
    return Y, H.conj().resolve_conj(), H.abs() ** 2


def wiener_init(Y, Ht, HtH, alpha, shape, impl: str = "auto") -> torch.Tensor:
    """Wiener deconvolution on the padded grid, cropped to ``shape`` (H, W)."""
    _, inv = _spec_fns(impl)
    return inv(Y * Ht / (HtH + 1.0 / alpha[:, None, None]), shape)


def x_update(Y, Ht, HtH, z, u, rho, shape, impl: str = "auto") -> torch.Tensor:
    """Closed-form Fourier solve of the quadratic x-subproblem.

    ``rho`` is (B, 1, 1) as in the JAX package; ``shape`` is the output
    stamp shape (H, W).  The pointwise solve runs in :func:`x_update_solve`.
    """
    fwd, inv = _spec_fns(impl)
    Z = fwd(rho * z - u)
    X = x_update_solve(Y, Ht, Z, HtH, rho.reshape(-1).float().contiguous())
    return inv(X, shape)


class UnrolledADMMGaussian(nn.Module):
    """The flagship unrolled PnP-ADMM (Gaussian likelihood).

    ``forward(obs, psf, alpha)``: obs, psf (B, H, W); alpha broadcastable to
    (B,).  Returns (B, H, W) float32, or a dict of (B, n_iters, ...) traces
    when ``analysis=True``.  ``rho_bounds=(lo, hi)`` maps the SubNet logits to
    lo * (hi/lo)^sigmoid(logit); it applies only with the SubNet.
    """

    def __init__(self, n_iters: int = 8, features: Sequence[int] = (32, 64, 128, 256), subnet: bool = True,
                 analysis: bool = False, rho_bounds: tuple[float, float] | None = None,
                 dtype: torch.dtype = torch.float32, fft_impl: str = "auto"):
        super().__init__()
        _spec_fns(fft_impl)
        self.n_iters = n_iters
        self.analysis = analysis
        self.rho_bounds = rho_bounds if subnet else None
        self.dtype = dtype
        self.fft_impl = fft_impl
        if subnet:
            self.subnet = SubNet(n_outputs=n_iters, raw=rho_bounds is not None, dtype=dtype)
        else:
            self.subnet = None
            self.rho_iters = nn.Parameter(torch.ones(n_iters))
        self.resunet = ResUNet(features=features).to(dtype)

    def _rho_schedule(self, psf, alpha, B):
        if self.subnet is None:
            return self.rho_iters[None, :].expand(B, self.n_iters)
        out = self.subnet(psf, alpha)
        if self.rho_bounds is None:
            return out
        lo, hi = self.rho_bounds
        return lo * (hi / lo) ** torch.sigmoid(out)

    def forward(self, obs: torch.Tensor, psf: torch.Tensor, alpha: torch.Tensor):
        B = obs.shape[0]
        alpha = alpha.reshape(B).float()
        y = obs.float().clamp_min(0.0)
        shape = (y.shape[-2], y.shape[-1])

        Y, Ht, HtH = gaussian_spectra(y, psf, self.fft_impl)
        rho_iters = self._rho_schedule(psf, alpha, B)

        z = wiener_init(Y, Ht, HtH, alpha, shape, self.fft_impl)
        u = torch.zeros_like(y)
        traces = {"x": [], "z": [], "u": [], "rho": []}
        for i in range(self.n_iters):
            rho = rho_iters[:, i, None, None]  # (B, 1, 1)
            x = x_update(Y, Ht, HtH, z, u, rho, shape, self.fft_impl)
            z = self.resunet((rho * x + u)[:, None].to(self.dtype))[:, 0].float()
            u = u + rho * (x - z)
            if self.analysis:
                traces["x"].append(x)
                traces["z"].append(z)
                traces["u"].append(u)
                traces["rho"].append(rho)
        if self.analysis:
            return {k: torch.stack(v, dim=1).float() for k, v in traces.items()}
        return z
