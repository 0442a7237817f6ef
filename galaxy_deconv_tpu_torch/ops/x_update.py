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

:func:`x_update_solve` launches the kernel on a CUDA tensor and raises if the
launch fails; on a CPU tensor it runs :func:`x_update_solve_plain`.  Each
launch adds one to ``x_update_solve.launches``.
"""

from __future__ import annotations

import ctypes

import torch

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


def _check(Y, Ht, Z, HtH, rho):
    for name, t, dtype, shape in (
        ("Y", Y, torch.complex64, Y.shape),
        ("Ht", Ht, torch.complex64, Y.shape),
        ("Z", Z, torch.complex64, Y.shape),
        ("HtH", HtH, torch.float32, Y.shape),
        ("rho", rho, torch.float32, Y.shape[:1]),
    ):
        if t.dtype != dtype:
            raise TypeError(f"x_update_solve: {name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"x_update_solve: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != Y.device:
            raise ValueError(f"x_update_solve: {name} is on {t.device}, Y on {Y.device}")
        if not t.is_contiguous():
            raise ValueError(f"x_update_solve: {name} must be contiguous")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"x_update_solve: {name} has a lazy conj/neg bit; call resolve_conj()")
    if Y.ndim < 2:
        raise ValueError("x_update_solve: Y must be (B, ...) with at least one spectral axis")


def _library():
    lib = native.load("x_update_solve")
    fn = lib.x_update_solve
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def x_update_solve(Y, Ht, Z, HtH, rho):
    """X = (Ht * Y + Z) / (rho + HtH) for batch-first spectra.

    Y, Ht, Z: complex64 (B, ...); HtH: float32 (B, ...); rho: float32 (B,);
    all contiguous on one device.  Returns complex64 (B, ...).
    """
    _check(Y, Ht, Z, HtH, rho)
    if Y.device.type == "cpu":
        return x_update_solve_plain(Y, Ht, Z, HtH, rho)
    if Y.device.type != "cuda":
        raise ValueError(f"x_update_solve: no kernel for device {Y.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (Y, Ht, Z, HtH, rho)):
        raise RuntimeError("x_update_solve: the CUDA kernel has no backward; call it under torch.no_grad()")
    out = torch.empty_like(Y)
    if out.numel() == 0:
        return out
    fn = _library()
    with torch.cuda.device(Y.device):
        rc = fn(Y.data_ptr(), Ht.data_ptr(), Z.data_ptr(), HtH.data_ptr(), rho.data_ptr(),
                out.data_ptr(), Y[0].numel(), Y.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"x_update_solve: kernel launch failed with CUDA error {rc}")
    x_update_solve.launches += 1
    return out


x_update_solve.launches = 0
