"""Train and eval steps and the training loop (counterpart of
``galaxy_deconv_tpu/train/loop.py:33-173``).

A train step: the forward in train mode (the SubNet's BatchNorm on batch
statistics), the loss, the backward, and the clipped Adam update, skipped
whole when the loss or any update is not finite.  BatchNorm writes its
running statistics during the forward, so the step snapshots them first and
restores them on a skipped step, as the JAX step keeps its ``batch_stats``.

The loop follows reference ``train.py:80-146``: validation every
``eval_every`` steps and after each epoch, a checkpoint on a new best
validation loss or every 5 epochs, and the history file.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from galaxy_deconv_tpu_torch.data.dataset import GalaxyDataset, iterate_batches, train_val_indices
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.train.state import ClippedAdam, TrainState, update_is_good
from galaxy_deconv_tpu_torch.utils.device import fp32_only

logger = logging.getLogger("galaxy_deconv_tpu_torch.train")


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensors(batch: dict, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32, device=device)
                 for k in ("obs", "psf", "alpha", "gt"))


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam):
    """The train step ``(state, batch) -> (state, loss)`` for ``state.model is
    model``; it updates the model and ``state`` in place.  The model's
    parameters must be float32: the JAX package trains in float32 only, and
    the step runs with TF32 off whatever the caller's flags."""
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
        loss = loss_fn(gt, model(obs, psf, alpha))
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
        updates, new_opt = optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            if bool(update_is_good(loss, updates)):
                for n, p in params.items():
                    p.add_(updates[n])
                state.opt_state = new_opt
            else:
                for b, s in zip(buffers, saved):
                    b.copy_(s)
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable):
    """The eval step ``(state, batch) -> loss``: eval-mode BatchNorm, no grad,
    TF32 off."""
    device = _device(model)

    @fp32_only()
    @torch.no_grad()
    def step(state: TrainState, batch: dict):
        obs, psf, alpha, gt = _tensors(batch, device)
        model.eval()
        return loss_fn(gt, model(obs, psf, alpha))

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
    pretrained_epochs: int = 0,
    max_val_batches: int = 50,
):
    """Training loop.  Returns (state, history dict)."""
    train_step = make_train_step(model, loss_fn, optimizer)
    eval_step = make_eval_step(model, loss_fn)

    tr_idx, va_idx = train_val_indices(len(dataset), train_val_split, seed)
    history = {"train_loss": [], "val_loss": [], "epoch_time": [], "best_step": 0}
    val_loss_min, epoch_min = float("inf"), 0

    def run_val():
        losses = []
        for i, vb in enumerate(iterate_batches(dataset, batch_size, indices=va_idx, drop_last=False)):
            if i >= max_val_batches:
                break
            losses.append(float(eval_step(state, vb)))
        return float(np.mean(losses)) if losses else float("nan")

    for epoch in range(n_epochs):
        t0 = time.time()
        epoch_losses = []
        for it, batch in enumerate(iterate_batches(dataset, batch_size, shuffle=True, seed=seed + epoch,
                                                   indices=tr_idx)):
            state, loss = train_step(state, batch)
            epoch_losses.append(float(loss))
            if eval_every and (it + 1) % eval_every == 0:
                logger.info("[%d: %d] train_loss=%.4g val_loss=%.4g",
                            epoch + 1, it + 1, np.mean(epoch_losses[-eval_every:]), run_val())

        train_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        val_loss = run_val()
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
                save_checkpoint(save_path, model_name, epoch + 1 + pretrained_epochs, state)

    history["best_epoch"] = epoch_min
    if save_path:
        with open(pathlib.Path(save_path) / f"{model_name}_history.json", "w") as f:
            json.dump(history, f)
    return state, history
