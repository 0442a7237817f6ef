"""Device-resident offline training (counterpart of
``galaxy_deconv_tpu/train/device_resident.py``).

A stored split that fits in device memory (the reference's 40,000 training
stamps are ~1.1 GB) is uploaded once; each minibatch is then gathered on the
device from an index tensor, so a step moves no stamps from the host.  Each
epoch's shuffled order is uploaded once as one tensor.  The order is the JAX
package's (``numpy.random.default_rng(seed)`` shuffling the training indices
in place every epoch), so both packages train on the same minibatches.  The
step is :func:`train.loop.make_train_step`'s.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from galaxy_deconv_tpu_torch.data.dataset import GalaxyDataset, train_val_indices
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.train.loop import make_eval_step, make_train_step
from galaxy_deconv_tpu_torch.train.state import ClippedAdam, TrainState

logger = logging.getLogger("galaxy_deconv_tpu_torch.train.device_resident")


def upload_split(ds: GalaxyDataset, limit: Optional[int] = None, device="cuda") -> dict:
    """The first ``limit`` samples (all by default) of a split on ``device``:
    obs, psf, gt and alpha (each observation's mean, computed on the host as
    the JAX package computes it)."""
    n = len(ds) if limit is None else min(limit, len(ds))
    obs = np.array(ds.obs[:n], np.float32)
    host = {"obs": obs, "psf": np.array(ds.psf[:n], np.float32), "gt": np.array(ds.gt[:n], np.float32),
            "alpha": obs.mean(axis=(-2, -1))}
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def _gather(data: dict, idx: torch.Tensor) -> dict:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def make_indexed_train_step(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam, data: dict):
    """``(state, idx) -> (state, loss)``: the minibatch ``idx`` (an int64
    tensor on the data's device) gathered on the device, then one train step;
    the loss stays on the device."""
    train_step = make_train_step(model, loss_fn, optimizer)

    def step(state: TrainState, idx: torch.Tensor):
        return train_step(state, _gather(data, idx))

    return step


def make_indexed_multi_step(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam, data: dict):
    """``(state, idxs[K, B]) -> (state, mean loss)``: K indexed steps queued
    back to back with no host sync between them (the JAX package's
    ``lax.scan`` of K steps), the mean of their losses on the device."""
    step = make_indexed_train_step(model, loss_fn, optimizer, data)

    def multi(state: TrainState, idxs: torch.Tensor):
        losses = []
        for idx in idxs:
            state, loss = step(state, idx)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    return multi


def fit_device_resident(
    model: nn.Module,
    state: TrainState,
    optimizer: ClippedAdam,
    loss_fn: Callable,
    dataset: GalaxyDataset,
    n_epochs: int = 10,
    batch_size: int = 32,
    train_val_split: float = 0.8,
    seed: int = 0,
    model_name: str = "model",
    save_path: Optional[str] = None,
    limit: Optional[int] = None,
):
    """Epoch training over a split uploaded to the model's device; returns
    (state, history) with ``train_loss``, ``val_loss`` and ``epoch_time`` per
    epoch.  Validation is one eval-mode batch of up to 512 validation samples;
    a checkpoint is saved on a new best validation loss and every 5 epochs."""
    device = next(model.parameters()).device
    data = upload_split(dataset, limit, device)
    n = int(data["obs"].shape[0])
    tr_idx, va_idx = train_val_indices(n, train_val_split, seed)
    step = make_indexed_train_step(model, loss_fn, optimizer, data)
    eval_step = make_eval_step(model, loss_fn)
    val_idx = torch.as_tensor(va_idx[: min(len(va_idx), 512)], dtype=torch.int64, device=device)

    rng = np.random.default_rng(seed)
    history = {"train_loss": [], "val_loss": [], "epoch_time": []}
    best = float("inf")
    for epoch in range(n_epochs):
        t0 = time.time()
        order = tr_idx.copy()
        rng.shuffle(order)
        order_dev = torch.as_tensor(order, dtype=torch.int64, device=device)
        losses = []
        for s in range(0, len(order) - batch_size + 1, batch_size):
            state, loss = step(state, order_dev[s: s + batch_size])
            losses.append(loss)
        val = float(eval_step(state, _gather(data, val_idx)))
        history["train_loss"].append(float(np.mean(torch.stack(losses).tolist())) if losses else float("nan"))
        history["val_loss"].append(val)
        history["epoch_time"].append(time.time() - t0)
        logger.info("epoch %d: train=%.4g val=%.4g (%.1fs)", epoch + 1, history["train_loss"][-1], val,
                    history["epoch_time"][-1])
        if save_path and (val < best or (epoch + 1) % 5 == 0):
            best = min(best, val)
            save_checkpoint(save_path, model_name, epoch + 1, state)
    return state, history
