"""Adaptive-moments (elliptical-Gaussian-fit) shear estimation (counterpart of
``galaxy_deconv_tpu/metrics/adaptive_moments.py``; its ngmix cross-check
runs where the optional ngmix package is installed).

The classic adaptive-moments fixed point (HSM/KSB family, Hirata & Seljak
2003): an elliptical Gaussian weight is iterated until its covariance matches
the weighted second moments of the stamp; the fixed point is the best-fit
elliptical Gaussian, giving centroid, size T and ellipticity per stamp.  For
a Gaussian image of covariance S and a weight of covariance W the weighted
moments measure P = (S^-1 + W^-1)^-1, and the update W <- 2P has S as its
fixed point.  Closed-form 2x2 algebra on the whole batch, ``n_iter`` rounds
launched back to back on the device (the JAX package's ``lax.fori_loop``).
"""

from __future__ import annotations

import numpy as np
import torch


def _weighted_moments(images, xs, ys, cx, cy, mxx, mxy, myy):
    det = torch.clamp_min(mxx * myy - mxy**2, 1e-6)
    wxx, wxy, wyy = (c[:, None, None] for c in (myy / det, -mxy / det, mxx / det))
    dx = xs - cx[:, None, None]
    dy = ys - cy[:, None, None]
    w = torch.exp(-0.5 * (wxx * dx**2 + 2 * wxy * dx * dy + wyy * dy**2))
    iw = images * w
    tot = iw.sum(dim=(-2, -1)) + 1e-12
    ncx = (iw * xs).sum(dim=(-2, -1)) / tot
    ncy = (iw * ys).sum(dim=(-2, -1)) / tot
    dx = xs - ncx[:, None, None]
    dy = ys - ncy[:, None, None]
    pxx = (iw * dx * dx).sum(dim=(-2, -1)) / tot
    pxy = (iw * dx * dy).sum(dim=(-2, -1)) / tot
    pyy = (iw * dy * dy).sum(dim=(-2, -1)) / tot
    return ncx, ncy, pxx, pxy, pyy, tot


def adaptive_moments(images: torch.Tensor, n_iter: int = 30) -> dict[str, torch.Tensor]:
    """Best-fit elliptical Gaussian of each (B, H, W) stamp: a dict of (B,)
    tensors cx, cy (pixels), T = Mxx + Myy, e1, e2 (distortion), flux (the
    weighted amplitude) and resid (how far from the fixed point)."""
    B, H, W = images.shape
    images = torch.clamp_min(images.float(), 0.0)
    ys = torch.arange(H, dtype=torch.float32, device=images.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=images.device)[None, None, :]

    def full(v):
        return torch.full((B,), v, dtype=torch.float32, device=images.device)

    cx, cy, mxx, mxy, myy = full((W - 1) / 2.0), full((H - 1) / 2.0), full(4.0), full(0.0), full(4.0)
    for _ in range(n_iter):
        cx, cy, pxx, pxy, pyy, _ = _weighted_moments(images, xs, ys, cx, cy, mxx, mxy, myy)
        # W <- 2P, floored to stay positive-definite
        mxx = torch.clamp_min(2 * pxx, 0.25)
        myy = torch.clamp_min(2 * pyy, 0.25)
        bound = torch.sqrt(mxx * myy) * 0.99
        mxy = torch.clamp(2 * pxy, -bound, bound)
    _, _, pxx, pxy, pyy, flux = _weighted_moments(images, xs, ys, cx, cy, mxx, mxy, myy)
    resid = torch.abs(2 * pxx - mxx) + torch.abs(2 * pyy - myy) + 2 * torch.abs(2 * pxy - mxy)

    T = mxx + myy
    e1 = (mxx - myy) / torch.clamp_min(T, 1e-6)
    e2 = 2 * mxy / torch.clamp_min(T, 1e-6)
    return {"cx": cx, "cy": cy, "T": T, "e1": e1, "e2": e2, "flux": flux, "resid": resid}


def estimate_shear_adaptive(images: torch.Tensor, n_iter: int = 30) -> torch.Tensor:
    """(B, H, W) -> (B, 3) of (g1, g2, |g|): the adaptive-moments distortion
    converted to reduced shear (e = 2g / (1 + |g|^2))."""
    m = adaptive_moments(images, n_iter)
    e = torch.sqrt(m["e1"] ** 2 + m["e2"] ** 2)
    e_safe = torch.clamp(e, 1e-12, 0.999)
    g_over_e = 1.0 / (1.0 + torch.sqrt(torch.clamp_min(1.0 - e_safe**2, 0.0)))
    g1, g2 = m["e1"] * g_over_e, m["e2"] * g_over_e
    return torch.stack([g1, g2, torch.hypot(g1, g2)], dim=-1)


def estimate_shear_ngmix_reference(obs: np.ndarray, psf: np.ndarray):
    """CPU cross-check via the real ngmix package when installed
    (the reference's bootstrapper recipe, utils/utils_ngmix.py)."""
    import ngmix  # optional dependency

    jac = ngmix.DiagonalJacobian(row=obs.shape[0] / 2, col=obs.shape[1] / 2, scale=0.2)
    psf_obs = ngmix.Observation(psf, jacobian=jac)
    o = ngmix.Observation(obs, jacobian=jac, psf=psf_obs)
    am = ngmix.admom.AdmomFitter()
    res = am.go(o, 0.3)
    return res["e1"], res["e2"]
