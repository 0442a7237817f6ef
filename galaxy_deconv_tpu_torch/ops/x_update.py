"""The ADMM x-update's pointwise spectral solve: CUDA kernel and plain version.

    X = (Ht * Y + Z) / (rho + HtH)        Ht = conj(H), one rho per galaxy

Replaces ``galaxy_deconv_tpu/ops/pallas_kernels.py::x_update_spectral_pallas``
(body ``_solve_kernel``).  The kernel, ``csrc/x_update_solve.cu``, takes the
model's batch-first layout: Y, Ht, Z complex64 (B, 2H, W+1), HtH fp32
(B, 2H, W+1), rho fp32 (B,).  It is memory-bound on an H100: 36 bytes move per
element for about 10 flops, so at the flagship's shapes (B = 256, 96 x 49
spectra, 43.4 MB) its bound is 12.9 us at 3.35 TB/s.  The design keeps the
traffic to one coalesced read of each operand and one write, one thread per
element, no shared memory.  There is no single PyTorch call for this function.

:func:`x_update_solve` goes through the autograd function :class:`XUpdateSolve`
on every device.  On a CUDA tensor its forward launches the kernel and its
backward the backward kernel, ``x_update_solve_backward`` in the same source
(28 bytes per element: 10.1 us at (256, 96, 49); S blocks per galaxy, S
picked by the launcher, in one thread-block cluster when S > 1, their partial
sums of grad_rho combined through distributed shared memory in a fixed order,
so the result is the same bit for bit every run); each raises if its launch
fails.  On a CPU tensor they run :func:`x_update_solve_plain` and
:func:`x_update_solve_backward_plain`.  Each kernel launch adds one to
``x_update_solve.launches`` or
``x_update_solve_backward.launches``.  Gradients flow to Z and rho only: Y, Ht
and HtH come from the observations and the PSF, which no training path
differentiates, so the function raises if any of them requires grad.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from galaxy_deconv_tpu_torch.ops import native

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def x_update_spectral(Yr, Yi, Hr, Hi, Zr, Zi, HtH, rho):
    """Plain solve with the JAX signature: (conj(H) * Y + Z) / (rho + HtH),
    split real/imag, where (Hr, Hi) are the planes of H itself.

    conj(H)*Y = (Hr*Yr + Hi*Yi) + i(Hr*Yi - Hi*Yr); every argument broadcasts.
    """
    denom = rho + HtH
    xr = (Hr * Yr + Hi * Yi + Zr) / denom
    xi = (Hr * Yi - Hi * Yr + Zi) / denom
    return xr, xi


def x_update_solve_plain(Y, Ht, Z, HtH, rho):
    """The kernel's function in plain PyTorch, on the kernel's layout.

    ``Ht`` is already conj(H), so H = conj(Ht): Hr = Re Ht, Hi = -Im Ht.
    """
    rho = rho.reshape(-1, *([1] * (Y.ndim - 1)))
    xr, xi = x_update_spectral(Y.real, Y.imag, Ht.real, -Ht.imag, Z.real, Z.imag, HtH, rho)
    return torch.complex(xr, xi)


def x_update_solve_backward_plain(G, X, HtH, rho):
    """The backward kernel's function in plain PyTorch: (grad_Z, grad_rho) for
    the incoming gradient G of X, with d = rho + HtH,

        grad_Z = G / d,   grad_rho[b] = -sum (Re G Re X + Im G Im X) / d  over galaxy b.
    """
    d = rho.reshape(-1, *([1] * (X.ndim - 1))) + HtH
    grad_rho = -((G.real * X.real + G.imag * X.imag) / d).sum(dim=tuple(range(1, X.ndim)))
    return G / d, grad_rho


def _check(fn, args):
    """Raise unless ``args`` ((name, tensor, dtype) with the first tensor the
    batch-first reference and rho last) suit the kernels."""
    ref = args[0][1]
    if ref.ndim < 2:
        raise ValueError(f"{fn}: {args[0][0]} must be (B, ...) with at least one spectral axis")
    for name, t, dtype in args:
        shape = ref.shape[:1] if name == "rho" else ref.shape
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, {args[0][0]} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"{fn}: {name} has a lazy conj/neg bit; call resolve_conj()")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {ref.device}")


def _library(name: str):
    fn = getattr(native.load("x_update_solve"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *tensors, n_per_gal: int, B: int) -> None:
    with torch.cuda.device(tensors[0].device):
        rc = _library(name)(*(t.data_ptr() for t in tensors), n_per_gal, B,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _solve(Y, Ht, Z, HtH, rho):
    _check("x_update_solve", (("Y", Y, torch.complex64), ("Ht", Ht, torch.complex64), ("Z", Z, torch.complex64),
                              ("HtH", HtH, torch.float32), ("rho", rho, torch.float32)))
    if Y.device.type == "cpu":
        return x_update_solve_plain(Y, Ht, Z, HtH, rho)
    out = torch.empty_like(Y)
    if out.numel() == 0:
        return out
    _launch("x_update_solve", Y, Ht, Z, HtH, rho, out, n_per_gal=Y[0].numel(), B=Y.shape[0])
    x_update_solve.launches += 1
    return out


def x_update_solve_backward(G, X, HtH, rho):
    """(grad_Z, grad_rho) of the solve for the incoming gradient G of its output X.

    G, X: complex64 (B, ...); HtH: float32 (B, ...); rho: float32 (B,); all
    contiguous on one device.  On CUDA it launches the backward kernel, on the
    CPU it runs :func:`x_update_solve_backward_plain`.
    """
    _check("x_update_solve_backward", (("G", G, torch.complex64), ("X", X, torch.complex64),
                                       ("HtH", HtH, torch.float32), ("rho", rho, torch.float32)))
    if G.device.type == "cpu":
        return x_update_solve_backward_plain(G, X, HtH, rho)
    grad_Z = torch.empty_like(G)
    grad_rho = torch.empty_like(rho)
    if grad_Z.numel() == 0:
        return grad_Z, grad_rho.zero_()
    _launch("x_update_solve_backward", G, X, HtH, rho, grad_Z, grad_rho, n_per_gal=G[0].numel(), B=G.shape[0])
    x_update_solve_backward.launches += 1
    return grad_Z, grad_rho


class XUpdateSolve(torch.autograd.Function):
    """The solve with its gradient with respect to Z and rho (see the module)."""

    @staticmethod
    def forward(ctx, Y, Ht, Z, HtH, rho):
        X = _solve(Y, Ht, Z, HtH, rho)
        ctx.save_for_backward(X, HtH, rho)
        return X

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        X, HtH, rho = ctx.saved_tensors
        grad_Z, grad_rho = x_update_solve_backward(G.resolve_conj().resolve_neg().contiguous(), X, HtH, rho)
        return None, None, grad_Z, None, grad_rho


def x_update_solve(Y, Ht, Z, HtH, rho):
    """X = (Ht * Y + Z) / (rho + HtH) for batch-first spectra, differentiable in
    Z and rho.

    Y, Ht, Z: complex64 (B, ...); HtH: float32 (B, ...); rho: float32 (B,);
    all contiguous on one device.  Returns complex64 (B, ...).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (Y, Ht, HtH)):
        raise RuntimeError("x_update_solve: no gradient with respect to Y, Ht or HtH; detach them")
    return XUpdateSolve.apply(Y, Ht, Z, HtH, rho)


x_update_solve.launches = 0
x_update_solve_backward.launches = 0
