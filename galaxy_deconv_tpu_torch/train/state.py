"""Train state and the optimizer (counterpart of ``galaxy_deconv_tpu/train/state.py:14-81``).

The JAX package trains with ``optax.chain(clip_by_global_norm(1.0), adam(lr))``.
:class:`ClippedAdam` computes the same arithmetic, in the same order, as a
pure function of the gradients and an :class:`AdamState`, so that a train step
can drop a bad update whole (see :func:`update_is_good`), as the JAX step does
with ``jnp.where``.  Two details differ from torch's own tools:
``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``, where optax scales
by ``max_norm / norm`` and only when ``norm >= max_norm``; and optax computes
the bias corrections ``1 - b**count`` in float32.  The update count lives on
the parameters' device, so that a step that is skipped keeps its count (as
the JAX step reverts it) without the host reading the device.

The arithmetic runs on every parameter at once, over the gradients and the
moments concatenated into one flat vector each (:meth:`ClippedAdam.update_flat`):
a few dozen launches a step whatever the number of tensors, where one set of
launches per tensor would keep the host busier than the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Mapping, Optional

import torch
from torch import nn

from galaxy_deconv_tpu_torch.pipeline import init_parameters

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX package trains with


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count (a 0-d int32 tensor on the
    parameters' device) and the two moments, keyed by parameter name."""

    count: torch.Tensor
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

    def learning_rate(self, count):
        """The learning rate of the update made at ``count`` earlier updates:
        a float for an int ``count``, a float32 tensor on its device for a
        tensor (optax's float32 arithmetic)."""
        if self.schedule is None:
            return self.lr
        alpha = 0.1
        if isinstance(count, torch.Tensor):
            frac = count.clamp(max=self.total_steps).to(torch.float32) / self.total_steps
            cosine = 0.5 * (1 + torch.cos(math.pi * frac))
        else:
            cosine = 0.5 * (1 + math.cos(math.pi * min(count, self.total_steps) / self.total_steps))
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, model: nn.Module) -> AdamState:
        """Zero moments on the device and dtype of each trainable parameter,
        the count 0 on the model's device."""
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return AdamState(new_count(0, _model_device(model)), {n: torch.zeros_like(p) for n, p in params.items()},
                         {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update_flat(self, grads: torch.Tensor, count: torch.Tensor, mu: torch.Tensor,
                    nu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(updates, count, mu, nu) after one step on the flat gradient vector
        ``grads`` (every parameter, in one order, as :func:`flatten` lays them
        out), from the flat moments ``mu`` and ``nu`` and the count; new
        tensors, the arguments left as they are."""
        norm = torch.sqrt((grads * grads).sum())
        g = torch.where(norm < self.clip_norm, grads, grads / norm * self.clip_norm)
        power = (count + 1).to(torch.float32)
        bc1 = 1 - torch.pow(B1, power)
        bc2 = 1 - torch.pow(B2, power)
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * (g * g) + B2 * nu
        updates = -self.learning_rate(count) * (mu / bc1 / (torch.sqrt(nu / bc2) + EPS))
        return updates, count + 1, mu, nu

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState) -> tuple[dict, AdamState]:
        """(updates, new state) for ``grads``; the caller adds the updates to
        the parameters.  Neither ``grads`` nor ``state`` is modified."""
        device = state.count.device
        updates, count, mu, nu = self.update_flat(flatten(grads.values(), device), state.count,
                                                  flatten((state.mu[n] for n in grads), device),
                                                  flatten((state.nu[n] for n in grads), device))
        return unflatten(updates, grads), AdamState(count, unflatten(mu, grads), unflatten(nu, grads))


def flatten(tensors: Iterable[torch.Tensor], device) -> torch.Tensor:
    """The tensors' entries end to end in one 1-d tensor (empty on ``device``
    when there are none)."""
    parts = [t.reshape(-1) for t in tensors]
    return torch.cat(parts) if parts else torch.zeros(0, device=device)


def unflatten(flat: torch.Tensor, like: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``flat`` cut back into views shaped as ``like``'s tensors, by name."""
    parts = flat.split([t.numel() for t in like.values()]) if like else ()
    return {n: v.view(t.shape) for (n, t), v in zip(like.items(), parts)}


def new_count(value: int, device) -> torch.Tensor:
    """An Adam update count: a 0-d int32 tensor on ``device``, written without
    a copy from the host."""
    return torch.full((), value, dtype=torch.int32, device=device)


def _model_device(model: nn.Module) -> torch.device:
    return next(iter(model.parameters()), torch.zeros(())).device


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
