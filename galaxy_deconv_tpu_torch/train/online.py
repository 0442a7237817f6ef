"""Online training: the simulator feeds the train step on the device
(counterpart of ``galaxy_deconv_tpu/train/online.py``).

Each step renders a fresh batch of galaxies, PSFs and observations on the
device with ``data/simulate.py`` and trains on it at once: no dataset touches
the disk or the host, and every galaxy is seen once.  ``steps_per_call > 1``
queues that many steps back to back with no host sync between them (the
counterpart of the JAX package's ``lax.scan``), keeps their losses on the
device and fetches them once per call.

The JAX package draws step i's batch from ``fold_in(PRNGKey(seed), i)``; the
port's draws come from ``torch.Generator``s, so step i's batch is
``sampler(step_seed(seed, TRAIN, i), ...)`` with the seed taken from
``numpy.random.SeedSequence``, and the validation batches from the fixed
seeds ``step_seed(seed, VAL, j)``: the same galaxies at every validation.
The two packages therefore see the same distribution of batches, not the same
batches; their steps agree on the same batch.
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

from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.train.loop import _device, make_eval_step, make_train_step
from galaxy_deconv_tpu_torch.train.state import ClippedAdam, TrainState
from galaxy_deconv_tpu_torch.utils.watchdog import StallWatchdog

logger = logging.getLogger("galaxy_deconv_tpu_torch.train.online")

TRAIN, VAL = 0, 1  # the seed streams of the training steps and of the validation batches


def step_seed(seed: int, stream: int, i: int) -> int:
    """The simulator seed of batch ``i`` of ``stream`` in a run seeded ``seed``."""
    return int(np.random.SeedSequence(seed, spawn_key=(stream, i)).generate_state(1, np.uint64)[0])


def _render(sampler: Callable, seed: int, batch_size: int, sim_cfg: sim.SimulationConfig, device) -> dict:
    batch = sampler(seed, batch_size, sim_cfg, device=device)
    # as the training contract: alpha is each sample's mean observation, not the simulation's truth
    return {**batch, "alpha": batch["obs"].mean(dim=(-2, -1))}


def make_online_train_step(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam, batch_size: int,
                           sim_cfg: sim.SimulationConfig = sim.SimulationConfig(),
                           sampler: Callable = sim.simulate_batch):
    """``(state, seed) -> (state, loss)``: render a batch from ``seed`` on the
    model's device and take :func:`train.loop.make_train_step`'s step on it;
    the loss stays on the device.  ``sampler``: ``simulate_batch`` (the
    deconvolution task) or ``simulate_batch_denoise`` (denoiser training)."""
    train_step, device = make_train_step(model, loss_fn, optimizer), _device(model)

    def step(state: TrainState, seed: int):
        return train_step(state, _render(sampler, seed, batch_size, sim_cfg, device))

    return step


def make_online_train_scan(model: nn.Module, loss_fn: Callable, optimizer: ClippedAdam, batch_size: int,
                           steps_per_call: int, sim_cfg: sim.SimulationConfig = sim.SimulationConfig(),
                           sampler: Callable = sim.simulate_batch):
    """``(state, seeds[steps_per_call]) -> (state, losses[steps_per_call])``:
    that many online steps queued back to back, none waiting for the device,
    the losses a tensor on the device.  The same steps as calling
    :func:`make_online_train_step` once per seed."""
    step = make_online_train_step(model, loss_fn, optimizer, batch_size, sim_cfg, sampler)

    def scan(state: TrainState, seeds):
        if len(seeds) != steps_per_call:
            raise ValueError(f"{len(seeds)} seeds for a call of {steps_per_call} steps")
        losses = []
        for seed in seeds:
            state, loss = step(state, seed)
            losses.append(loss)
        return state, torch.stack(losses)

    return scan


def make_online_eval_step(model: nn.Module, loss_fn: Callable, batch_size: int,
                          sim_cfg: sim.SimulationConfig = sim.SimulationConfig(),
                          sampler: Callable = sim.simulate_batch):
    """``(state, seed) -> loss`` on the batch rendered from ``seed``, BatchNorm
    in eval mode."""
    eval_step, device = make_eval_step(model, loss_fn), _device(model)

    def step(state: TrainState, seed: int):
        return eval_step(state, _render(sampler, seed, batch_size, sim_cfg, device))

    return step


def fit_online(
    model: nn.Module,
    state: TrainState,
    optimizer: ClippedAdam,
    loss_fn: Callable,
    n_steps: int,
    batch_size: int = 64,
    sim_cfg: sim.SimulationConfig = sim.SimulationConfig(),
    seed: int = 0,
    log_every: int = 100,
    val_every: int = 500,
    val_batches: int = 4,
    model_name: str = "model",
    save_path: Optional[str] = None,
    save_every: int = 5000,
    sampler: Callable = sim.simulate_batch,
    steps_per_call: int = 1,
    stall_timeout_s: Optional[float] = 600.0,
):
    """Online training loop; returns (state, history).

    Validation averages the loss over ``val_batches`` batches rendered from
    fixed seeds, so validation losses compare across the run; a new best
    validation loss saves a checkpoint named after the step, as does every
    ``save_every`` steps.  ``steps_per_call > 1`` runs that many steps per
    call (the same steps; the losses still recorded per step) and snaps the
    cadences and ``n_steps`` to multiples of it.  The history (``step``,
    ``train_loss``, ``val_loss``, ``best_step``, ``galaxies_per_sec``) is
    written to ``{model_name}_history.json`` under ``save_path``.
    ``stall_timeout_s``: if no call completes for this long the process exits
    with ``utils.watchdog.STALL_EXIT_CODE``; None disables.
    """
    k = max(1, steps_per_call)
    # the cadences and the step budget snapped to whole calls (a cadence of 0 stays 0)
    log_every, val_every, save_every, n_steps = (max(k, k * (v // k)) if v else v
                                                 for v in (log_every, val_every, save_every, n_steps))
    train_scan = make_online_train_scan(model, loss_fn, optimizer, batch_size, k, sim_cfg, sampler)
    eval_step = make_online_eval_step(model, loss_fn, batch_size, sim_cfg, sampler)
    val_seeds = [step_seed(seed, VAL, j) for j in range(val_batches)]

    history = {"step": [], "train_loss": [], "val_loss": [], "best_step": 0}
    best_val = float("inf")
    window = []
    t0 = time.time()
    with StallWatchdog(stall_timeout_s, name=f"fit_online[{model_name}]") as dog:
        for first in range(0, n_steps, k):
            state, losses = train_scan(state, [step_seed(seed, TRAIN, first + j) for j in range(k)])
            window.extend(losses.tolist())  # the call's one wait for the device
            dog.beat()
            i = first + k - 1  # the cadences fire on the call's last step
            if log_every and (i + 1) % log_every == 0:
                rate = (i + 1) * batch_size / (time.time() - t0)
                logger.info("step %d: train=%.5g (%.0f gal/s)", i + 1, np.mean(window[-log_every:]), rate)
            if val_every and (i + 1) % val_every == 0:
                val = float(np.mean([float(eval_step(state, s)) for s in val_seeds]))
                dog.beat()
                history["step"].append(i + 1)
                history["train_loss"].append(float(np.mean(window[-val_every:])))
                history["val_loss"].append(val)
                logger.info("step %d: val=%.5g", i + 1, val)
                if val < best_val:
                    best_val = val
                    history["best_step"] = i + 1
                    if save_path:
                        save_checkpoint(save_path, model_name, i + 1, state)
            if save_path and save_every and (i + 1) % save_every == 0:
                save_checkpoint(save_path, model_name, i + 1, state)
    history["galaxies_per_sec"] = len(window) * batch_size / (time.time() - t0)
    if save_path:
        # names the best-validation checkpoint for checkpoint.best_epoch
        pathlib.Path(save_path).mkdir(parents=True, exist_ok=True)
        with open(pathlib.Path(save_path) / f"{model_name}_history.json", "w") as f:
            json.dump(history, f)
    return state, history
