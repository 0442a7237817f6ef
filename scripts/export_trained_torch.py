"""Export the best checkpoint of each run into a directory of port checkpoints
(counterpart of ``scripts/export_trained.py``).

Copies each run's best-validation checkpoint (named by the run's history
file, ``train/checkpoint.py::best_epoch``; the latest without one) from
``--src`` into ``--dst`` as ``{name}_{N}epochs/train_state.pt`` with the
optimizer state emptied, the layout ``scripts/trained_to_port.py`` writes:
weights and BatchNorm statistics, all that ``cli test --model_save_path DST
--checkpoint_name NAME`` and the other scripts read.

Usage: python scripts/export_trained_torch.py [--src saved_models_online_torch] [--dst trained_torch]
"""

import argparse
import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from galaxy_deconv_tpu_torch.train.checkpoint import STATE_FILE, best_epoch, restore_checkpoint  # noqa: E402

RUN = re.compile(r"^(?P<name>.+)_(?P<epoch>\d+)epochs$")


def run_names(src) -> list:
    """Every run name with a checkpoint directory in ``src``."""
    return sorted({m.group("name") for p in pathlib.Path(src).iterdir() if (m := RUN.match(p.name))})


def export_run(src, dst, name: str):
    """Write ``name``'s best checkpoint in ``src`` into ``dst`` without its
    optimizer state; (epoch, output directory, parameter count), or None when
    ``src`` holds no checkpoint of it."""
    ep = best_epoch(src, name)
    if not ep:
        return None
    payload = restore_checkpoint(src, name, ep)
    out = pathlib.Path(dst) / f"{name}_{ep}epochs"
    out.mkdir(parents=True, exist_ok=True)
    torch.save({"step": int(payload["step"]), "model": payload["model"],
                "opt_state": {"count": 0, "mu": {}, "nu": {}}}, out / STATE_FILE)
    n = sum(t.numel() for k, t in payload["model"].items() if "running_" not in k and "num_batches" not in k)
    return ep, out, n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default="saved_models_online_torch")
    parser.add_argument("--dst", default="trained_torch")
    parser.add_argument("--runs", nargs="*", default=None, help="default: every run found in --src")
    args = parser.parse_args(argv)

    runs = args.runs if args.runs is not None else run_names(args.src)
    dst = pathlib.Path(args.dst).resolve()
    dst.mkdir(parents=True, exist_ok=True)
    for name in runs:
        done = export_run(args.src, dst, name)
        if done is None:
            print(f"skip {name}: no checkpoints")
            continue
        ep, out, n = done
        print(f"exported {name} step {ep} -> {out} ({n:,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
