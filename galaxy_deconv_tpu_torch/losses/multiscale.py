"""MultiScale and MSE losses (counterpart of ``galaxy_deconv_tpu/losses/multiscale.py``).

MultiScale, the default training loss: the sum over scales s of
2^-s * L(avgpool_{2^s}(a), avgpool_{2^s}(b)) with L the L1 or L2 norm and an
optional auxiliary loss added at each scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from galaxy_deconv_tpu_torch.ops.resize import average_downsample


def mse_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((output - target) ** 2).mean()


def l1_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (output - target).abs().mean()


@dataclasses.dataclass(frozen=True)
class MultiScaleLoss:
    """Called as ``loss(gt, rec)``, the reference's order: ``flux_normalize``
    divides each sample by its ground truth's mean |flux| (+1e-3), a scale
    that carries no gradient, so faint stamps weigh as much as bright ones."""

    scales: int = 3
    norm: str = "L1"
    aux_loss_fn: Optional[Callable] = None
    aux_weight: float = 0.1
    flux_normalize: bool = False

    def __call__(self, gt: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
        base = l1_loss if self.norm == "L1" else mse_loss
        if self.flux_normalize:
            axes = tuple(range(1, gt.ndim))
            scale = gt.abs().mean(dim=axes).detach() + 1e-3
            w = (1.0 / scale).reshape((-1,) + (1,) * (gt.ndim - 1))
            gt = gt * w
            rec = rec * w
        total = 0.0
        for s in range(self.scales):
            rate = 2**s
            o = average_downsample(gt, rate) if rate > 1 else gt
            t = average_downsample(rec, rate) if rate > 1 else rec
            term = base(o, t)
            if self.aux_loss_fn is not None:
                term = term + self.aux_weight * self.aux_loss_fn(o, t)
            total = total + term / rate
        return total
