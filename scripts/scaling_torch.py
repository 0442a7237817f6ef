"""Data-parallel scaling of the train step (counterpart of ``scripts/scaling.py``).

Measures the galaxies/sec of the data-parallel train step
(``train/loop.py::make_train_step`` with a mesh, ``parallel/``) at world
sizes 1, N/2 and N, where N is the launcher's world size: each size runs on
the first ranks of the group, in a group of their own, the other ranks
waiting.  Start it with one process per card:

  torchrun --standalone --nproc_per_node N scripts/scaling_torch.py

Without a launcher it runs alone, at world size 1, with no process group; on
a machine with one card, ``--nproc_per_node 1`` measures world size 1 over
NCCL, which is all such a machine can measure.  The batch is
``bench.py``'s stamps, ``--per_device_batch`` per rank, the flagship at
``--n_iters`` iterations and full width, weights from seed 0.  The rate
comes from the host clock around ``--steps`` steps after one, the last
loss fetched inside the window.

  python scripts/scaling_torch.py --device cpu          # one process on the CPU
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from galaxy_deconv_tpu_torch.bench import bench_inputs  # noqa: E402
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss  # noqa: E402
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian  # noqa: E402
from galaxy_deconv_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch  # noqa: E402
from galaxy_deconv_tpu_torch.parallel.mesh import Mesh, barrier  # noqa: E402
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer, make_train_step  # noqa: E402

FEATURES = (32, 64, 128, 256)


def world_sizes(n_total: int) -> list:
    """The world sizes measured: 1, half the ranks and all of them."""
    return sorted({1, max(1, n_total // 2), n_total})


def make_batch(n: int) -> dict:
    """``n`` of ``bench.py``'s stamps, gt half the observation."""
    obs, psf, alpha = bench_inputs(n)
    return {"obs": obs, "psf": psf, "alpha": alpha, "gt": obs * 0.5}


def sub_mesh(world: Mesh, nd: int):
    """The mesh of the first ``nd`` ranks of ``world`` (None on the others);
    every rank must call it, as ``torch.distributed.new_group`` requires."""
    if nd == world.world_size:
        return world
    group = dist.new_group(list(range(nd)))
    if world.rank >= nd:
        return None
    return Mesh(group if nd > 1 else None, world.rank, nd, world.device)


def step_rate(mesh: Mesh, n_iters: int, per_device_batch: int, steps: int) -> float:
    """Global gal/s of the train step on ``mesh``: one step, then ``steps``
    timed ones."""
    global_batch = per_device_batch * mesh.world_size
    batch = shard_batch(make_batch(global_batch), mesh)
    model = UnrolledADMMGaussian(n_iters=n_iters, features=FEATURES).to(mesh.device)
    state, opt = create_train_state(model, 0, default_optimizer())
    step = make_train_step(model, MultiScaleLoss(), opt, mesh=mesh if mesh.group is not None else None)
    state, loss = step(state, batch)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch)
    float(loss)  # the host fetch waits for the last step
    return global_batch / ((time.perf_counter() - t0) / steps)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--per_device_batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--n_iters", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    initialize_distributed(args.device)
    world = make_mesh(None, args.device)
    name = torch.cuda.get_device_name(world.device) if world.device.type == "cuda" else "cpu"
    backend = dist.get_backend() if dist.is_initialized() else "no process group"
    if world.rank == 0:
        print(f"{world.world_size} process(es) ({backend}), {world.world_size} device(s): {name}")
    sizes = world_sizes(world.world_size)
    results = {}
    for nd in sizes:
        mesh = sub_mesh(world, nd)
        if mesh is not None:
            results[nd] = step_rate(mesh, args.n_iters, args.per_device_batch, args.steps)
        barrier(world)
        if world.rank == 0:
            eff = results[nd] / results[sizes[0]] / nd * sizes[0]
            print(f"{nd} device(s): {results[nd]:.0f} gal/s train  ({eff:.2f} scaling eff.)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
