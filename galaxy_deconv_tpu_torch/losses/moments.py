"""Moment-based loss: centroid + second- and third-order central image moments
(counterpart of ``galaxy_deconv_tpu/losses/moments.py``; reference
``utils/utils_train.py:185-254`` with ``compute_moments`` of
``utils/fit_ellipse.py:467-548``, batched).  Each image is min-max
normalised before its moments are taken.
"""

from __future__ import annotations

import dataclasses

import torch


def normalize_images(batch: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalisation of (B, H, W) to [0, 1]."""
    lo = batch.amin(dim=(-2, -1), keepdim=True)
    hi = batch.amax(dim=(-2, -1), keepdim=True)
    return (batch - lo) / torch.clamp_min(hi - lo, 1e-8)


def compute_moments(images: torch.Tensor) -> dict[str, torch.Tensor]:
    """Moments up to order 3 of (B, H, W) images, each (B,): m00, cx, cy,
    mu20, mu11, mu02, mu30, mu21, mu12, mu03.  x runs along the columns
    (axis -1), y along the rows (axis -2), the reference's convention."""
    images = normalize_images(images)
    B, H, W = images.shape
    ys = torch.arange(H, dtype=torch.float32, device=images.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=images.device)[None, None, :]

    m00 = images.sum(dim=(-2, -1)) + 1e-8
    cx = (images * xs).sum(dim=(-2, -1)) / m00
    cy = (images * ys).sum(dim=(-2, -1)) / m00
    dx = xs - cx[:, None, None]
    dy = ys - cy[:, None, None]

    def cm(px, py):
        return (images * dx**px * dy**py).sum(dim=(-2, -1)) / m00

    return {"m00": m00, "cx": cx, "cy": cy, "mu20": cm(2, 0), "mu11": cm(1, 1), "mu02": cm(0, 2),
            "mu30": cm(3, 0), "mu21": cm(2, 1), "mu12": cm(1, 2), "mu03": cm(0, 3)}


def ellipse_params_from_moments(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 5) ellipse parameters (cy, cx, theta, a, b) from the
    eigendecomposition of the second-moment tensor (reference
    ``utils/fit_ellipse.py:550-601``, batched)."""
    m = compute_moments(images)
    delta = m["mu20"] - m["mu02"]
    theta = 0.5 * torch.atan2(2 * m["mu11"], delta + 1e-8)
    trace = m["mu20"] + m["mu02"]
    det = m["mu20"] * m["mu02"] - m["mu11"] ** 2
    disc = torch.sqrt(torch.clamp_min(trace**2 - 4 * det, 0.0) + 1e-8)
    lam1 = torch.clamp_min(0.5 * (trace + disc), 1e-6)
    lam2 = torch.clamp_min(0.5 * (trace - disc), 1e-6)
    return torch.stack([m["cy"], m["cx"], theta, torch.sqrt(lam1), torch.sqrt(lam2)], dim=-1)


@dataclasses.dataclass(frozen=True)
class MomentBasedLoss:
    centroid_weight: float = 1.0
    central_moments_weight: float = 1.0
    third_order_weight: float = 1.0

    def __call__(self, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        mo = compute_moments(output)
        mt = compute_moments(target)

        def mse_of(keys):
            return torch.stack([(mo[k] - mt[k]) ** 2 for k in keys], dim=-1).mean()

        return (self.centroid_weight * mse_of(["cy", "cx"])
                + self.central_moments_weight * mse_of(["mu20", "mu11", "mu02"])
                + self.third_order_weight * mse_of(["mu30", "mu21", "mu12", "mu03"]))
