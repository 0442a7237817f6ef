"""Differentiable best-level ellipse-fit loss (counterpart of
``galaxy_deconv_tpu/losses/best_ellipse.py``; reference
``utils/utils_train.py:24-129`` with ``utils/fit_ellipse.py``): algebraic
ellipses are fitted (a weighted conic fit by SVD) to soft iso-intensity masks
at several intensity levels, each level's fit to the ground truth is scored by
an inside/outside contrast, the best level is picked per sample, and the
fits of output and target at that level are compared (centre, angle cosine,
axes).

As in the JAX package, every (level x sample) fit is one batched
``torch.linalg.svd`` over an (L*B, H*W, 6) design tensor, the per-sample level
is a gather, and a fit that is not finite falls back to (W/2, H/2, 0, 10, 10)
through ``torch.where``; nothing waits for the device.

The conic is the right singular vector of the smallest singular value, whose
sign no SVD fixes.  The centre does not depend on it, but theta moves by
pi/2 and the axes a and b swap under a flip, so the loss depends on the
solver's sign choice (LAPACK's in the JAX package on the CPU, torch's LAPACK
on the CPU, cuSOLVER's on the card).  This quirk of the JAX package is kept
as it is.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch


def min_max_normalize(images: torch.Tensor) -> torch.Tensor:
    lo = images.amin(dim=(-2, -1), keepdim=True)
    hi = images.amax(dim=(-2, -1), keepdim=True)
    return torch.where(hi > lo, (images - lo) / (hi - lo + 1e-8), images)


def sigmoid_mask(x: torch.Tensor, peak_pos, sharpness: float = 0.1) -> torch.Tensor:
    """A Gaussian bump selecting the pixels near a normalised intensity."""
    return torch.exp(-(((x - peak_pos) / sharpness) ** 2))


@functools.lru_cache(maxsize=8)
def _levels_and_grid(levels: tuple, H: int, W: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The levels (L,) and the (H*W, 2) grid of (row, col) coordinates,
    float32 on ``device``, made there once."""
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    pts = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
    return torch.tensor(levels, dtype=torch.float32).to(device), pts.to(device)


@functools.lru_cache(maxsize=8)
def _fallback(H: int, W: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([W / 2.0, H / 2.0, 0.0, 10.0, 10.0], dtype=torch.float32).to(device)


def weighted_ellipse_fit(points: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted algebraic conic fit: the right singular vector of the smallest
    singular value of the weighted design matrix [x^2, xy, y^2, x, y, 1].
    points (..., N, 2), weights (..., N) -> unit coefficients (..., 6).  The
    first point component (the image row) is the conic's 'x', as in the
    reference."""
    x, y = points[..., 0], points[..., 1]
    D = torch.stack([x**2, x * y, y**2, x, y, torch.ones_like(x)], dim=-1)
    _, _, vt = torch.linalg.svd(D * weights[..., None], full_matrices=False)
    coeffs = vt[..., -1, :]
    return coeffs / (torch.linalg.vector_norm(coeffs, dim=-1, keepdim=True) + 1e-8)


def conic_to_params(coeffs: torch.Tensor) -> torch.Tensor:
    """Conic coefficients (..., 6) -> ellipse parameters (..., 5) = (cx, cy, theta, a, b)."""
    A, B, C, D, E, F = coeffs.unbind(-1)
    den = 4 * A * C - B**2
    cx = (B * E - 2 * C * D) / (den + 1e-8)
    cy = (B * D - 2 * A * E) / (den + 1e-8)
    theta = 0.5 * torch.atan2(B, A - C)
    ct, st = torch.cos(theta), torch.sin(theta)
    expr = A * cx**2 + C * cy**2 + B * cx * cy + D * cx + E * cy + F
    a2 = -2 * expr / (A * ct**2 + B * ct * st + C * st**2 + 1e-8)
    b2 = -2 * expr / (A * st**2 - B * ct * st + C * ct**2 + 1e-8)
    return torch.stack([cx, cy, theta, torch.sqrt(torch.abs(a2)), torch.sqrt(torch.abs(b2))], dim=-1)


def ellipse_coeffs(images: torch.Tensor, levels: Sequence[float], sharpness: float = 0.1) -> torch.Tensor:
    """The conic of each (B, H, W) image at each level, (L, B, 6): one batched
    SVD over (L*B, H*W, 6)."""
    B, H, W = images.shape
    lv, pts = _levels_and_grid(tuple(float(v) for v in levels), H, W, images.device)
    mask = sigmoid_mask(images[None], lv[:, None, None, None], sharpness).reshape(len(lv) * B, H * W)
    coeffs = weighted_ellipse_fit(pts.expand(len(lv) * B, H * W, 2), mask)
    return coeffs.reshape(len(lv), B, 6)


def ellipse_params(coeffs: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Ellipse parameters (..., 5) of conics (..., 6) fitted on (H, W)
    images, the rows that are not finite replaced by (W/2, H/2, 0, 10, 10),
    the reference's safe fallback."""
    params = conic_to_params(coeffs)
    return torch.where(torch.isfinite(params).all(dim=-1, keepdim=True), params, _fallback(H, W, coeffs.device))


def ellipse_fit_metric(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Score in [0, 1] of how well an ellipse isolates the flux: the
    distance-weighted mean intensity inside against the mean outside.
    images (B, H, W), params (..., B, 5) as (cy, cx, theta, a, b) in the
    reference's row/column convention -> (..., B)."""
    _, H, W = images.shape
    cy, cx, theta, a, b = (p[..., None, None] for p in params.unbind(-1))
    ys = torch.arange(H, dtype=torch.float32, device=images.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=images.device)[None, :]
    xt, yt = xs - cx, ys - cy
    ct, st = torch.cos(theta), torch.sin(theta)
    xr = xt * ct + yt * st
    yr = -xt * st + yt * ct
    ellipse_eq = (xr / (a + 1e-8)) ** 2 + (yr / (b + 1e-8)) ** 2

    inside = (ellipse_eq <= 1.0).to(images.dtype)
    outside = 1.0 - inside
    dist = torch.sqrt((xt / (a + 1e-8)) ** 2 + (yt / (b + 1e-8)) ** 2)
    w = torch.clamp(1.0 - 0.5 * dist, 0.5, 1.0)

    eps = 1e-8
    n_in = inside.sum(dim=(-2, -1))
    n_out = outside.sum(dim=(-2, -1))
    mean_in = (images * inside * w).sum(dim=(-2, -1)) / (n_in + eps)
    mean_out = (images * outside).sum(dim=(-2, -1)) / (n_out + eps)
    ratio = mean_in / (mean_out + eps)
    ratio = torch.where(n_out < eps, 10.0, ratio)
    ratio = torch.where(n_in < eps, 0.0, ratio)
    return ratio / (1.0 + ratio)


@dataclasses.dataclass(frozen=True)
class BestEllipseLoss:
    ellipse_levels: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7)
    center_weight: float = 1.0
    angle_weight: float = 1.0
    axis_weight: float = 1.0
    sharpness: float = 0.1

    def _pairwise(self, out_p: torch.Tensor, tgt_p: torch.Tensor) -> torch.Tensor:
        cx_o, cy_o, th_o, a_o, b_o = out_p.unbind(-1)
        cx_t, cy_t, th_t, a_t, b_t = tgt_p.unbind(-1)
        scale = torch.maximum(torch.maximum(a_o, b_o), torch.maximum(a_t, b_t)) + 1e-8
        center = 0.5 * (((cx_o - cx_t) / scale) ** 2 + ((cy_o - cy_t) / scale) ** 2)
        angle = 1.0 - (torch.cos(th_o) * torch.cos(th_t) + torch.sin(th_o) * torch.sin(th_t))
        axis = 0.5 * (((a_o - a_t) / scale) ** 2 + ((b_o - b_t) / scale) ** 2)
        return self.center_weight * center + self.angle_weight * angle + self.axis_weight * axis

    def conics(self, images: torch.Tensor) -> torch.Tensor:
        """The (L, B, 6) conics of the min-max normalised (B, H, W) images."""
        return ellipse_coeffs(min_max_normalize(images), self.ellipse_levels, self.sharpness)

    def from_conics(self, target: torch.Tensor, out_conics: torch.Tensor, tgt_conics: torch.Tensor) -> torch.Tensor:
        """The loss given the conics of output and target (:meth:`conics`)."""
        _, H, W = target.shape
        out_params, tgt_params = ellipse_params(out_conics, H, W), ellipse_params(tgt_conics, H, W)  # (L, B, 5)
        best = ellipse_fit_metric(min_max_normalize(target), tgt_params).argmax(dim=0)  # (B,)
        take = lambda p: p.gather(0, best[None, :, None].expand(1, -1, 5))[0]  # noqa: E731
        return self._pairwise(take(out_params), take(tgt_params)).mean()

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self.from_conics(target, self.conics(output), self.conics(target))
