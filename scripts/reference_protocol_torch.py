"""The reference-protocol training experiment on the card (counterpart of
``scripts/reference_protocol.py``).

Replicates the reference's training protocol (reference ``train.py:25-143``
and its command-line defaults) inside the port, to test whether its
fixed-dataset epoch regime, not the unrolled depth, orders the ADMM depths:

* a FIXED dataset of ``--n_stamps`` stamps (the reference's n_train, 40,000)
  from the train split's random-SNR distribution, simulated once on the
  device in chunks from ``--seed`` (the train split ``cli generate`` writes
  with that seed and chunk) and held there (~1.1 GB of obs, psf and
  gt at 40,000), so every epoch revisits the same galaxies as a disk dataset
  would; alpha is each observation's mean;
* train/val split 0.9 (``data/dataset.py::train_val_indices``), batch 32,
  Adam at a constant lr 2e-4 (the reference has no schedule), global-norm
  clip 1.0, the MultiScale loss, ``--steps_per_call`` steps queued per call
  (``train/device_resident.py::make_indexed_multi_step``);
* ``--epochs`` epochs with the reference's save rule (:func:`should_save`:
  a new best validation loss, or every 5 epochs); the best epoch goes into
  the run's history file, which ``train/checkpoint.py::best_epoch`` reads,
  so the benchmark sweep takes the best-validation checkpoint as the
  reference selects its model;
* a fresh initialisation per depth.

Validation averages the loss over the whole batches of ``8 * --batch``
validation stamps; a validation split smaller than one such batch gives no
validation loss (nan), as in the JAX script.  The report under ``--out``
is merged across invocations, each run stamped with its protocol.

Usage: python scripts/reference_protocol_torch.py [--epochs 50] [--models 8 4 2] [--device cpu]
"""

import argparse
import json
import logging
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data.dataset import chunk_plan, train_val_indices  # noqa: E402
from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig, simulate_batch  # noqa: E402
from galaxy_deconv_tpu_torch.losses import build_loss  # noqa: E402
from galaxy_deconv_tpu_torch.models import Tikhonet, UnrolledADMMGaussian  # noqa: E402
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer, make_eval_step  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from galaxy_deconv_tpu_torch.train.device_resident import make_indexed_multi_step  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import resolve_device  # noqa: E402
from galaxy_deconv_tpu_torch.utils.watchdog import StallWatchdog  # noqa: E402

FEATURES = (32, 64, 128, 256)
SAVE_EVERY = 5  # reference train.py:137-143


def should_save(epoch: int, val: float, best: float) -> bool:
    """The reference's save rule after 1-based ``epoch``: a validation loss
    below the best so far, or every :data:`SAVE_EVERY` epochs."""
    return val < best or epoch % SAVE_EVERY == 0


def saved_epochs(val_losses) -> tuple[list, int]:
    """The epochs the save rule checkpoints over a run's validation losses,
    and the best epoch (0 when no loss improved on infinity)."""
    best, best_ep, saved = float("inf"), 0, []
    for epoch, val in enumerate(val_losses, 1):
        if should_save(epoch, val, best):
            saved.append(epoch)
        if val < best:
            best, best_ep = val, epoch
    return saved, best_ep


def fixed_dataset(n_stamps: int, chunk: int, seed: int, cfg: SimulationConfig, device, dog=None) -> dict:
    """obs, psf, gt and alpha (each observation's mean) of ``n_stamps`` stamps
    rendered on ``device`` in chunks: the train split that
    ``data/dataset.py::generate_dataset`` renders with this seed and chunk."""
    chunks = []
    for k, n in chunk_plan(seed, n_stamps, 0, chunk)[0]:
        b = simulate_batch(k, n, cfg, device)
        chunks.append({f: b[f] for f in ("obs", "psf", "gt")})
        if dog is not None:
            dog.beat()
    data = {f: torch.cat([c[f] for c in chunks]) for f in ("obs", "psf", "gt")}
    data["alpha"] = data["obs"].mean(dim=(-2, -1))
    return data


def build(spec: str):
    """(run name, model, loss name) of a ``--models`` entry."""
    if spec == "shapenet":
        return "RefProto_ShapeNet_Laplacian_Shape", Tikhonet(filter="Laplacian"), "Shape"
    n_iters = int(spec)
    return (f"RefProto_Gaussian_PnP_ADMM_{n_iters}iters_MultiScale",
            UnrolledADMMGaussian(features=FEATURES, n_iters=n_iters), "MultiScale")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["8", "4", "2"],
                    help="ADMM depths (8/4/2) and/or 'shapenet' (Tikhonet+Shape under the same protocol)")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--n_stamps", type=int, default=40000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--split", type=float, default=0.9)
    ap.add_argument("--chunk", type=int, default=1000, help="simulation chunk size")
    ap.add_argument("--steps_per_call", type=int, default=10, help="train steps queued back to back per call")
    ap.add_argument("--seed", type=int, default=31415)
    ap.add_argument("--save_path", default="saved_models_online_torch")
    ap.add_argument("--out", default="figures/reference_protocol_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    dog = StallWatchdog(600.0, name="refproto[sim]").start()
    data = fixed_dataset(args.n_stamps, args.chunk, args.seed, SimulationConfig(), device, dog)
    n = int(data["obs"].shape[0])
    print(f"fixed dataset: {n} stamps resident on {data['obs'].device}")
    tr_idx, va_idx = train_val_indices(n, args.split, args.seed)
    dog.stop()

    report = {"runs": {}}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():  # per-depth invocations merge into one report
        report["runs"].update(json.loads(out.read_text()).get("runs", {}))

    val_batch = args.batch * 8
    val_idx = [torch.as_tensor(va_idx[s: s + val_batch], dtype=torch.int64, device=device)
               for s in range(0, len(va_idx) - val_batch + 1, val_batch)]
    for spec in args.models:
        name, model, loss_name = build(spec)
        loss_fn = build_loss(loss_name)
        # stamped per run, so runs of other protocols merged into one report keep their own
        protocol = {"epochs": args.epochs, "n_stamps": n, "batch": args.batch, "lr": args.lr,
                    "split": args.split, "loss": loss_name, "lr_schedule": "constant", "selection": "best-val"}
        dog = StallWatchdog(600.0, name=f"refproto[{name}]").start()
        model = model.to(device)
        state, optimizer = create_train_state(model, 0, default_optimizer(args.lr))  # constant lr + clip 1.0
        multi_step = make_indexed_multi_step(model, loss_fn, optimizer, data)
        eval_step = make_eval_step(model, loss_fn)

        def full_val():
            vals = [float(eval_step(state, {k: v.index_select(0, idx) for k, v in data.items()})) for idx in val_idx]
            return float(np.mean(vals)) if vals else float("nan")

        rng = np.random.default_rng(args.seed)
        hist = {"train_loss": [], "val_loss": [], "epoch_time": []}
        best, best_epoch_n = float("inf"), 0
        spc = args.steps_per_call
        print(f"=== {name}: {args.epochs} epochs x {len(tr_idx) // args.batch} steps ===")
        for epoch in range(1, args.epochs + 1):
            t0 = time.time()
            order = tr_idx.copy()
            rng.shuffle(order)
            n_calls = len(order) // args.batch // spc
            order_dev = torch.as_tensor(order[: n_calls * spc * args.batch], dtype=torch.int64, device=device)
            losses = []
            for c in range(n_calls):
                idxs = order_dev[c * spc * args.batch: (c + 1) * spc * args.batch].reshape(spc, args.batch)
                state, loss = multi_step(state, idxs)
                losses.append(float(loss))  # the call's one wait for the device
                dog.beat()
            val = full_val()
            hist["train_loss"].append(float(np.mean(losses)) if losses else float("nan"))
            hist["val_loss"].append(val)
            hist["epoch_time"].append(time.time() - t0)
            print(f"  epoch {epoch}/{args.epochs}: train={hist['train_loss'][-1]:.5g} "
                  f"val={val:.5g} ({hist['epoch_time'][-1]:.1f}s)")
            if should_save(epoch, val, best):
                if val < best:
                    best, best_epoch_n = val, epoch
                save_checkpoint(args.save_path, name, epoch, state)
        # the best epoch for the benchmark sweep's best-validation selection (checkpoint.best_epoch)
        pathlib.Path(args.save_path).mkdir(parents=True, exist_ok=True)
        hist_file = pathlib.Path(args.save_path) / f"{name}_history.json"
        hist_file.write_text(json.dumps({"best_step": best_epoch_n, **hist}))
        report["runs"][name] = {"best_epoch": best_epoch_n, "best_val": best, "protocol": protocol, **hist}
        out.write_text(json.dumps(report, indent=1))
        print(f"{name}: best val {best:.5g} at epoch {best_epoch_n}")
        dog.stop()
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
