"""Process groups, the data mesh and batch sharding (counterpart of
``galaxy_deconv_tpu/parallel/mesh.py``).

JAX runs one process over a list of devices; PyTorch runs one process per
device (``torchrun --nproc_per_node N``), so the port's mesh is the process
group of every rank, and each rank holds its contiguous 1/world slice of every
global batch on its own device.  Parameters are replicated by construction
(every rank builds them from the same seed, and :func:`broadcast_parameters`
makes sure once before training); the train step averages the flat gradient
with one all-reduce.

With gloo, every collective the port makes is an all-reduce or a broadcast,
which gloo runs on CUDA tensors as well as on CPU tensors: an all-gather is an
all-reduce of a zero buffer in which each rank fills its own rows
(:func:`all_gather_rows`), exact, since adding zeros rounds nothing.  Nothing
is copied through the host.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from galaxy_deconv_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the environment a launcher (torchrun) sets for every rank
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(device: str | torch.device = "cuda", **kwargs) -> None:
    """Join the process group, idempotent.

    With no configuration at all (no ``kwargs`` and none of ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` in the environment) this does nothing and
    the process runs alone, with no group.  An explicit configuration that
    fails to connect raises: a job that silently fell back to one process
    would train on 1/N of its data while looking healthy.  A group already
    initialised in this process is kept.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU unless a
    ``backend`` kwarg names another (two ranks sharing one card need gloo:
    NCCL refuses two ranks on one device).  The other kwargs go to
    ``torch.distributed.init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``timeout``); without them the launcher's
    environment configures the group.
    """
    if dist.is_initialized():
        logger.info("torch.distributed already initialized; world size %d", dist.get_world_size())
        return
    if not kwargs and not any(k in os.environ for k in LAUNCHER_ENV):
        logger.info("no process group configured; running as one process")
        return
    dev = resolve_device(device)
    backend = kwargs.pop("backend", None) or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() if dev.index is None else dev.index)
    dist.init_process_group(backend=backend, **kwargs)
    logger.info("joined a %s process group: rank %d of %d", backend, dist.get_rank(), dist.get_world_size())


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data mesh as one rank sees it: the process group (None when the
    process runs alone), this rank, the number of ranks, and this rank's
    device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device: str | torch.device = "cuda") -> Mesh:
    """The 1-D data mesh over every rank of the process group (one process
    when there is none).

    ``n_devices`` None means the world size; any other value must equal it,
    or this raises.  ``device`` "cuda" gives this rank ``cuda:LOCAL_RANK``;
    a device with an index (``cuda:0``) is taken as it is, so two ranks can
    share one card; "cpu" gives the CPU.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} rank(s): run one process "
                         f"per device, e.g. torchrun --nproc_per_node {n_devices} -m galaxy_deconv_tpu_torch ...")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return Mesh(dist.group.WORLD if dist.is_initialized() else None, dist.get_rank() if dist.is_initialized() else 0,
                world, dev)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of a global batch of ``n`` rows; raises
    when ``n`` does not divide by the world size, as JAX's placement of a
    batch-sharded array does."""
    if n % mesh.world_size:
        raise ValueError(f"a global batch of {n} rows does not divide over the {mesh.world_size} ranks of the mesh")
    k = n // mesh.world_size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous 1/world slice of every entry of a global batch
    (numpy arrays or tensors, axis 0 the galaxies), as float32 tensors on the
    rank's device."""
    out = {}
    for k, v in batch.items():
        rows = shard_rows(v.shape[0], mesh)
        v = v[rows]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v, np.float32))
        out[k] = v.to(mesh.device, torch.float32)
    return out


@torch.no_grad()
def broadcast_parameters(model: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers on every rank (JAX's replicated
    sharding); nothing without a group."""
    if mesh.group is None:
        return
    for t in [*model.parameters(), *model.buffers()]:
        dist.broadcast(t.data, src=0, group=mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' (n, ...) tensors stacked in rank order, (world * n, ...), on
    every rank: one all-reduce of a zero buffer holding this rank's rows."""
    if mesh.group is None:
        return x
    n = x.shape[0]
    buf = x.new_zeros((mesh.world_size * n, *x.shape[1:]))
    buf[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(buf, group=mesh.group)
    return buf


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank; nothing without a group."""
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes the files a run leaves (rank 0, or a process alone)."""
    return mesh is None or mesh.rank == 0
