"""Statistics over the global batch inside a data-parallel step.

Under a JAX mesh the batch is one sharded array, so every statistic over the
batch axis (train-mode BatchNorm's mean and variance, a loss term that is a
function of a batch mean) is taken over the global batch.  A rank holds only
its shard: inside :func:`global_batch` such statistics are all-reduced over
the mesh's group with ``torch.distributed.nn.functional.all_reduce``, whose
backward all-reduces the incoming gradients, so autograd passes through.
Outside it (one process, or no group) nothing is reduced.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def global_batch(group: Optional[dist.ProcessGroup]):
    """Inside the block, :func:`batch_sum` and :func:`batch_mean` reduce over
    ``group``; nothing when it is None or has one rank, whose batch is the
    global batch (the statistics are then computed exactly as without a
    group)."""
    global _GROUP
    prev, _GROUP = _GROUP, group if group is not None and dist.get_world_size(group) > 1 else None
    try:
        yield
    finally:
        _GROUP = prev


def in_global_batch() -> bool:
    """Whether a group is active (:func:`global_batch`)."""
    return _GROUP is not None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the active group, differentiably; ``x``
    itself outside :func:`global_batch`."""
    return x if _GROUP is None else dist_nn.all_reduce(x, group=_GROUP)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a per-shard mean ``x``: the global batch's
    mean when every shard holds the same number of samples."""
    return x if _GROUP is None else batch_sum(x) / dist.get_world_size(_GROUP)
