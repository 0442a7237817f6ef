"""Train state and the optimizer (counterpart of ``galaxy_deconv_tpu/train/state.py:14-81``).

The JAX package trains with ``optax.chain(clip_by_global_norm(1.0), adam(lr))``.
:class:`ClippedAdam` computes the same arithmetic, in the same order, as a
pure function of the gradients and an :class:`AdamState`, so that a train step
can drop a bad update whole (see :func:`update_is_good`), as the JAX step does
with ``jnp.where``.  Two details differ from torch's own tools:
``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``, where optax scales
by ``max_norm / norm`` and only when ``norm >= max_norm``; and optax computes
the bias corrections ``1 - b**count`` in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from galaxy_deconv_tpu_torch.pipeline import init_parameters

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX package trains with


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and the two moments,
    keyed by parameter name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step count, the model (parameters and
    BatchNorm statistics) and the optimizer state."""

    step: int
    model: nn.Module
    opt_state: AdamState


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    corrected) after clipping the gradients' global norm to ``clip_norm``.

    ``schedule="cosine"`` decays the learning rate to lr/10 over
    ``total_steps`` (``optax.cosine_decay_schedule(lr, total_steps, alpha=0.1)``).
    """

    lr: float = 2e-4
    clip_norm: float = 1.0
    schedule: Optional[str] = None
    total_steps: Optional[int] = None

    def __post_init__(self):
        if self.schedule not in (None, "cosine"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.schedule == "cosine" and not (self.total_steps or 0) > 0:
            raise ValueError("schedule='cosine' needs total_steps > 0")

    def learning_rate(self, count: int) -> float:
        """The learning rate of the update made at ``count`` earlier updates."""
        if self.schedule is None:
            return self.lr
        alpha = 0.1
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, self.total_steps) / self.total_steps))
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, model: nn.Module) -> AdamState:
        """Zero moments on the device and dtype of each trainable parameter."""
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return AdamState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                         {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState) -> tuple[dict, AdamState]:
        """(updates, new state) for ``grads``; the caller adds the updates to
        the parameters.  Neither ``grads`` nor ``state`` is modified."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()) + torch.zeros(()))
        unclipped = norm < self.clip_norm
        count = state.count + 1
        bc1 = float(1 - np.float32(B1) ** count)
        bc2 = float(1 - np.float32(B2) ** count)
        step = -self.learning_rate(state.count)
        updates, mu, nu = {}, {}, {}
        for name, g in grads.items():
            g = torch.where(unclipped, g, g / norm * self.clip_norm)
            mu[name] = (1 - B1) * g + B1 * state.mu[name]
            nu[name] = (1 - B2) * (g * g) + B2 * state.nu[name]
            updates[name] = step * (mu[name] / bc1 / (torch.sqrt(nu[name] / bc2) + EPS))
        return updates, AdamState(count, mu, nu)


def default_optimizer(lr: float = 2e-4, clip_norm: float = 1.0, schedule: Optional[str] = None,
                      total_steps: Optional[int] = None) -> ClippedAdam:
    """Adam with global-norm clipping (reference train.py:76,90: clip 1.0)."""
    return ClippedAdam(lr=lr, clip_norm=clip_norm, schedule=schedule, total_steps=total_steps)


def update_is_good(loss: torch.Tensor, updates: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """True iff the loss and every update entry are finite (a 0-d bool tensor).

    A finite loss can come with non-finite gradients; applying such an update
    corrupts the parameters for good, so the train step skips it whole."""
    finite = [torch.isfinite(loss).all()] + [torch.isfinite(u).all() for u in updates.values()]
    return torch.stack(finite).all()


def create_train_state(model: nn.Module, seed: int, optimizer: Optional[ClippedAdam] = None,
                       frozen_mask_fn: Optional[Callable[[str], bool]] = None) -> tuple[TrainState, ClippedAdam]:
    """Weights from ``seed`` (:func:`pipeline.init_parameters`, any device) and a
    fresh optimizer state on the model's device.

    ``frozen_mask_fn(name) -> bool`` marks parameters that never train
    (ADMMNet's frozen denoiser, loaded after this call): they get
    ``requires_grad=False``, so, as under the JAX package's
    ``optax.multi_transform(..., set_to_zero())``, they have no Adam moments,
    their gradients stay out of the clip's global norm, and they never move;
    the checkpoint still carries them."""
    init_parameters(model, seed)
    if frozen_mask_fn is not None:
        for name, p in model.named_parameters():
            if frozen_mask_fn(name):
                p.requires_grad_(False)
    optimizer = optimizer or default_optimizer()
    return TrainState(step=0, model=model, opt_state=optimizer.init(model)), optimizer
