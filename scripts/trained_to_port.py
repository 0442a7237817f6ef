"""Carry the JAX package's trained checkpoints into the PyTorch port's format.

    python scripts/trained_to_port.py --dst port_models                       # every run in trained/
    python scripts/trained_to_port.py --dst port_models --runs Tikhonet_Laplacian_MultiScale_5000epochs

Needs JAX and orbax (it reads orbax checkpoints), so it runs where the JAX
package runs, not on the card's machine.  Each ``{name}_{N}epochs`` under
``--src`` becomes ``{dst}/{name}_{N}epochs/train_state.pt``, the port's
checkpoint file, through the weight bridge
(``galaxy_deconv_tpu_torch/utils/convert_flax.py::model_state_dict``).  The
committed checkpoints hold no optimizer state, so the port's files hold the
weights and BatchNorm statistics with empty Adam moments: enough for
``cli test --model_save_path DST --checkpoint_name NAME``, not to resume
training.  A ``ResUNet_*`` run's file also serves ``ADMMNet``, whose frozen
denoiser has the same ``resunet.`` keys.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(REPO / "trained"))
    parser.add_argument("--dst", required=True)
    parser.add_argument("--runs", nargs="*", default=None, help="{name}_{N}epochs directories; default: all")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from galaxy_deconv_tpu.train.checkpoint import restore_checkpoint, unpack_variables
    from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict

    src, dst = pathlib.Path(args.src), pathlib.Path(args.dst)
    runs = args.runs or sorted(p.name for p in src.iterdir() if re.fullmatch(r".+_\d+epochs", p.name))
    for run in runs:
        name, epoch = re.fullmatch(r"(.+)_(\d+)epochs", run).groups()
        v = jax.tree.map(np.asarray, unpack_variables(restore_checkpoint(src, name, int(epoch))))
        sd = model_state_dict(v["params"], v.get("batch_stats"))
        out = dst / run
        out.mkdir(parents=True, exist_ok=True)
        torch.save({"step": 0, "model": sd, "opt_state": {"count": 0, "mu": {}, "nu": {}}}, out / "train_state.pt")
        print(f"{run}: {sum(t.numel() for t in sd.values()):,} values -> {out / 'train_state.pt'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
