"""Train and eval steps and the training loop (counterpart of
``galaxy_deconv_tpu/train/loop.py:33-173``).

A train step: the forward in train mode (the SubNet's BatchNorm on batch
statistics), the loss, the backward, and the clipped Adam update, skipped
whole when the loss or any update is not finite.  BatchNorm writes its
running statistics during the forward, so the step snapshots them first and
restores them on a skipped step, as the JAX step keeps its ``batch_stats``.
The skip is a selection on the device (``torch.where`` over the flat
vectors of the update and of Adam's moments, as the JAX step's
``jnp.where``): the step never waits for the device, so steps queue back to
back.  The online and device-resident trainers (``train/online.py``,
``train/device_resident.py``) run this same step on batches they make on the
device.

The loop follows reference ``train.py:80-146``: validation every
``eval_every`` steps and after each epoch, a checkpoint on a new best
validation loss or every 5 epochs, and the history file.

Data parallel (``mesh``, ``parallel/mesh.py``; the JAX package's ``fit(mesh=...)``):
each rank runs the step on its shard of the global batch, its BatchNorm
statistics and any loss term that is a function of a batch mean taken over the
global batch (``parallel.global_batch``); after the backward one all-reduce
averages the flat gradient vector and the loss together, so the clip's global
norm, the update and the skip of a bad update are the same on every rank and
the replicas never drift apart.  Averaging the ranks' losses gives the global
loss because every loss ``build_loss`` makes is a mean of per-sample terms over
equal shards, apart from the Shape loss's constraint term, which reduces its
batch mean over the group itself (``losses/shape_constraint.py``).
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from galaxy_deconv_tpu_torch.data.dataset import GalaxyDataset, iterate_batches, train_val_indices
from galaxy_deconv_tpu_torch.parallel import Mesh, barrier, broadcast_parameters, global_batch, is_writer, shard_batch
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.train.state import AdamState, ClippedAdam, TrainState, flatten, unflatten, update_is_good
from galaxy_deconv_tpu_torch.utils.device import fp32_only
from galaxy_deconv_tpu_torch.utils.watchdog import StallWatchdog

logger = logging.getLogger("galaxy_deconv_tpu_torch.train")


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensors(batch: dict, device: torch.device) -> tuple[torch.Tensor, ...]:
    """obs, psf, alpha, gt as float32 tensors on ``device``; tensors already
    there are used as they are."""
    return tuple(torch.as_tensor(v if isinstance(v := batch[k], torch.Tensor) else np.asarray(v),
                                 dtype=torch.float32, device=device) for k in ("obs", "psf", "alpha", "gt"))


def _distributed(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def _rank_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t``, a tensor no one else holds, averaged over the ranks of ``mesh``
    with one all-reduce (in place)."""
    dist.all_reduce(t, group=mesh.group)
    return t.div_(mesh.world_size)


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam, mesh: Optional[Mesh] = None):
    """The train step ``(state, batch) -> (state, loss)`` for ``state.model is
    model``; it updates the model and ``state`` in place and returns the loss
    as a 0-d tensor on the device, without waiting for it.  ``batch`` holds
    obs, psf, alpha and gt, numpy arrays or tensors.  The model's parameters
    must be float32: the JAX package trains in float32 only, and the step runs
    with TF32 off whatever the caller's flags.

    With ``mesh`` the batch is this rank's shard (``parallel.shard_batch``) and
    the loss returned is the mean over the ranks, the global batch's loss."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    wrong = sorted({str(p.dtype) for p in params.values()} - {"torch.float32"})
    if wrong:
        raise TypeError(f"make_train_step trains float32 parameters only; the model has {', '.join(wrong)}")
    buffers = list(model.buffers())
    device = _device(model)

    @fp32_only()
    def step(state: TrainState, batch: dict):
        obs, psf, alpha, gt = _tensors(batch, device)
        saved = [b.clone() for b in buffers]
        model.train()
        for p in params.values():
            p.grad = None
        with global_batch(None if mesh is None else mesh.group):
            loss = loss_fn(gt, model(obs, psf, alpha))
        if params:  # else every parameter is frozen and nothing trains
            loss.backward()
        with torch.no_grad():
            old = state.opt_state
            mu, nu = (flatten((m[n] for n in params), device) for m in (old.mu, old.nu))
            grads = flatten((torch.zeros_like(p) if p.grad is None else p.grad for p in params.values()), device)
            if _distributed(mesh):  # the gradient and the loss in one all-reduce
                buf = _rank_mean(torch.cat([grads, loss.detach().reshape(1)]), mesh)
                grads, loss = buf[:-1], buf[-1]
            updates, count, new_mu, new_nu = optimizer.update_flat(grads, old.count, mu, nu)
            # one selection over each flat vector: the update, the moments and the count
            good = update_is_good(loss, {"all": updates})
            if params:
                torch._foreach_add_(list(params.values()),
                                    list(unflatten(torch.where(good, updates, 0.0), params).values()))
            state.opt_state = AdamState(torch.where(good, count, old.count),
                                        unflatten(torch.where(good, new_mu, mu), params),
                                        unflatten(torch.where(good, new_nu, nu), params))
            for b, s in zip(buffers, saved):
                b.copy_(torch.where(good, b, s))
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable, mesh: Optional[Mesh] = None):
    """The eval step ``(state, batch) -> loss``: eval-mode BatchNorm, no grad,
    TF32 off; with ``mesh``, on this rank's shard, the loss the mean over the
    ranks."""
    device = _device(model)

    @fp32_only()
    @torch.no_grad()
    def step(state: TrainState, batch: dict):
        obs, psf, alpha, gt = _tensors(batch, device)
        model.eval()
        with global_batch(None if mesh is None else mesh.group):
            loss = loss_fn(gt, model(obs, psf, alpha))
        return _rank_mean(loss, mesh) if _distributed(mesh) else loss

    return step


def fit(
    model: nn.Module,
    state: TrainState,
    optimizer: ClippedAdam,
    loss_fn: Callable,
    dataset: GalaxyDataset,
    n_epochs: int = 10,
    batch_size: int = 32,
    train_val_split: float = 0.8,
    eval_every: int = 25,
    seed: int = 0,
    model_name: str = "model",
    save_path: Optional[str] = None,
    mesh: Optional[Mesh] = None,
    pretrained_epochs: int = 0,
    max_val_batches: int = 50,
    stall_timeout_s: Optional[float] = 600.0,
):
    """Training loop.  Returns (state, history dict).

    ``mesh``: data parallel over its ranks.  Every rank draws the same
    shuffled global batches of ``batch_size`` and trains on its shard (a
    batch, the last validation batch too, must divide by the world size, as
    under JAX's mesh); rank 0 alone writes the checkpoints and the history,
    every rank waiting for each write.

    ``stall_timeout_s``: if no train step or validation completes for this
    long, the process exits with ``utils.watchdog.STALL_EXIT_CODE`` for a
    supervisor to restart it from the last checkpoint; None disables (each
    rank keeps its own watchdog)."""
    train_step = make_train_step(model, loss_fn, optimizer, mesh)
    eval_step = make_eval_step(model, loss_fn, mesh)
    place = (lambda b: b) if mesh is None else (lambda b: shard_batch(b, mesh))
    if mesh is not None:
        broadcast_parameters(model, mesh)

    tr_idx, va_idx = train_val_indices(len(dataset), train_val_split, seed)
    history = {"train_loss": [], "val_loss": [], "epoch_time": [], "best_step": 0}
    val_loss_min, epoch_min = float("inf"), 0

    def run_val():
        losses = []
        for i, vb in enumerate(iterate_batches(dataset, batch_size, indices=va_idx, drop_last=False)):
            if i >= max_val_batches:
                break
            losses.append(float(eval_step(state, place(vb))))
        return float(np.mean(losses)) if losses else float("nan")

    # a context manager, so that the watchdog is disarmed on any exit
    with StallWatchdog(stall_timeout_s, name=f"fit[{model_name}]") as dog:
        for epoch in range(n_epochs):
            t0 = time.time()
            epoch_losses = []
            for it, batch in enumerate(iterate_batches(dataset, batch_size, shuffle=True, seed=seed + epoch,
                                                       indices=tr_idx)):
                state, loss = train_step(state, place(batch))
                epoch_losses.append(float(loss))
                dog.beat()  # float(loss) waited for the step
                if eval_every and (it + 1) % eval_every == 0:
                    logger.info("[%d: %d] train_loss=%.4g val_loss=%.4g",
                                epoch + 1, it + 1, np.mean(epoch_losses[-eval_every:]), run_val())
                    dog.beat()

            train_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            val_loss = run_val()
            dog.beat()
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["epoch_time"].append(time.time() - t0)
            logger.info("epoch %d: train=%.4g val=%.4g (%.1fs)", epoch + 1, train_loss, val_loss,
                        history["epoch_time"][-1])

            if val_loss < val_loss_min or (epoch + 1) % 5 == 0:
                if val_loss < val_loss_min:
                    val_loss_min, epoch_min = val_loss, epoch
                    # the checkpoint epoch that checkpoint.best_epoch reads back
                    history["best_step"] = epoch + 1 + pretrained_epochs
                if save_path:
                    if is_writer(mesh):
                        save_checkpoint(save_path, model_name, epoch + 1 + pretrained_epochs, state)
                    barrier(mesh)

    history["best_epoch"] = epoch_min
    if save_path:
        if is_writer(mesh):
            with open(pathlib.Path(save_path) / f"{model_name}_history.json", "w") as f:
                json.dump(history, f)
        barrier(mesh)
    return state, history
