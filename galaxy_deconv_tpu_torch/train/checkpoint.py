"""Checkpoints (counterpart of ``galaxy_deconv_tpu/train/checkpoint.py:23-74``).

A checkpoint is the directory ``{model_name}_{epoch}epochs`` under the save
path, as the JAX package names its orbax checkpoints, holding one file written
by ``torch.save``: the step, the model's state_dict (parameters and BatchNorm
statistics) and the optimizer state.  It is read back with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Optional

import torch

from galaxy_deconv_tpu_torch.train.state import AdamState, TrainState, new_count

STATE_FILE = "train_state.pt"


def _ckpt_dir(save_path, model_name: str, epoch: int) -> pathlib.Path:
    return pathlib.Path(save_path).resolve() / f"{model_name}_{epoch}epochs"


def state_payload(state: TrainState) -> dict:
    """A train state as plain tensors and numbers: what a checkpoint file holds
    (the Adam count read back from the device as an int)."""
    opt = state.opt_state
    return {"step": state.step, "model": state.model.state_dict(),
            "opt_state": {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}}


def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Copy ``payload`` (see :func:`state_payload`) into ``state``, onto the
    model's device; the model's keys must match exactly."""
    device = next(state.model.parameters()).device
    state.model.load_state_dict(payload["model"])
    opt = payload["opt_state"]
    if opt["mu"].keys() != state.opt_state.mu.keys():
        raise KeyError("the checkpoint's optimizer moments name other parameters than the model's")
    state.opt_state = AdamState(new_count(int(opt["count"]), device), {k: v.to(device) for k, v in opt["mu"].items()},
                                {k: v.to(device) for k, v in opt["nu"].items()})
    state.step = int(payload["step"])
    return state


def save_checkpoint(save_path, model_name: str, epoch: int, state: TrainState) -> pathlib.Path:
    path = _ckpt_dir(save_path, model_name, epoch)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(state_payload(state), tmp)
    os.replace(tmp, path / STATE_FILE)
    return path


def restore_checkpoint(save_path, model_name: str, epoch: int, state: Optional[TrainState] = None):
    """With ``state``, load the checkpoint into it and return it; without,
    return the checkpoint's payload (tensors on the CPU)."""
    payload = torch.load(_ckpt_dir(save_path, model_name, epoch) / STATE_FILE, map_location="cpu",
                         weights_only=True)
    return payload if state is None else load_payload(state, payload)


def unpack_variables(state) -> dict:
    """A restored checkpoint (TrainState or payload) -> the model's state_dict."""
    return state.model.state_dict() if isinstance(state, TrainState) else state["model"]


def best_epoch(save_path, model_name: str) -> int:
    """The best-validation epoch recorded in ``fit``'s history file, else
    :func:`latest_epoch`."""
    hist = pathlib.Path(save_path) / f"{model_name}_history.json"
    if hist.exists():
        best = json.loads(hist.read_text()).get("best_step", 0)
        if best and _ckpt_dir(save_path, model_name, best).exists():
            return best
    return latest_epoch(save_path, model_name)


def latest_epoch(save_path, model_name: str) -> int:
    """Highest saved epoch for a run name, 0 if none."""
    root = pathlib.Path(save_path)
    if not root.exists():
        return 0
    pat = re.compile(re.escape(model_name) + r"_(\d+)epochs$")
    epochs = [int(m.group(1)) for p in root.iterdir() if (m := pat.match(p.name))]
    return max(epochs, default=0)


def find_checkpoint(model_name: str, *save_paths) -> tuple[Optional[pathlib.Path], int]:
    """The first of ``save_paths`` holding a checkpoint of ``model_name`` and
    its :func:`best_epoch`; ``(None, 0)`` when none does (the scripts' lookup
    of a run in a scratch directory first, then in a directory of exported
    checkpoints)."""
    for path in save_paths:
        epoch = best_epoch(path, model_name)
        if epoch:
            return pathlib.Path(path), epoch
    return None, 0
