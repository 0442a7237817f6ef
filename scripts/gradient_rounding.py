"""Where ``chip_smoke.py`` phase 6 (b)'s gradient readings fall, over many
weight draws: how far fp32 rounding alone moves the flagship's train-step
gradients, and how far the card's fp32 step and its TF32 control sit from
the CPU's.

    python3 scripts/gradient_rounding.py [--weight-seeds 8] [--noise-seeds 3]

For each weight seed (``init_parameters``: flax's truncated lecun_normal),
one fp32 train step (``chip_smoke.one_train_step``: full width, 8 unrolled
iterations, the 8 galaxies of phase 6 (b)) on the CPU is the reference, and
``chip_smoke.grad_errors`` reads against it, as phase 6 (b) does:

- ``cpu ulp``: the CPU's step on observations moved by one ulp up or down
  (one reading per noise seed), the reference's own rounding;
- ``card``: the card's fp32 step, what phase 6 (b) holds to GRAD_REL_TOL;
- ``card again``: the card's step run a second time, against the CPU;
- ``card ulp``: the card's step on observations one ulp apart (noise seed 0)
  against the card's own step, the card's own rounding;
- ``tf32``: the card's forward, loss and backward with TF32 on, phase 6
  (b)'s control, which GRAD_REL_TOL must reject.

The last line gives the largest fp32 reading and the smallest TF32 reading
over all seeds: the range a fixed GRAD_REL_TOL must lie in.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from galaxy_deconv_tpu_torch.data import GalaxyDataset  # noqa: E402


def one_ulp_apart(batch: dict, seed: int) -> dict:
    """``batch`` with each observation pixel moved by one ulp up or down (numpy ``seed``)."""
    obs = np.asarray(batch["obs"])
    sign = np.random.default_rng(seed).choice(np.float32([-1, 1]), size=obs.shape)
    return {**batch, "obs": obs * (1 + np.float32(2.0**-23) * sign)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weight-seeds", type=int, default=8)
    p.add_argument("--noise-seeds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gradient_rounding: no CUDA device is available", file=sys.stderr)
        return 1
    cpu, card = torch.device("cpu"), torch.device("cuda")
    n_iters, features = cs.FLAGSHIP["n_iters"], cs.FLAGSHIP["features"]
    with tempfile.TemporaryDirectory(prefix="gradient_rounding_") as tmp:
        batch = GalaxyDataset(cs.write_dataset(pathlib.Path(tmp), cs.N_STAMPS)).batch(np.arange(cs.N_CPU_CHECK))
    print(f"{cs.card_line()}; torch {torch.__version__}; {cs.N_CPU_CHECK} galaxies, n_iters {n_iters}, "
          f"features {features}; worst per-parameter gradient rel err (parameter)")
    sound, control = [], []
    for w in range(args.weight_seeds):
        def step(device, b=batch, tf32=False):
            return cs.one_train_step(device, b, n_iters, features, seed=w, tf32=tf32)

        def read(got, ref):
            _, rel, worst, _ = cs.grad_errors(*got, *ref)
            return rel, f"{rel:.3e} ({worst})"

        ref = step(cpu)
        cpu_ulp = [read(step(cpu, one_ulp_apart(batch, s)), ref) for s in range(args.noise_seeds)]
        card_ref = step(card)
        card_fp32 = read(card_ref, ref)
        card_again = read(step(card), ref)
        card_ulp = read(step(card, one_ulp_apart(batch, 0)), card_ref)
        tf32 = read(step(card, tf32=True), ref)
        readings = [r for r, _ in cpu_ulp] + [card_fp32[0], card_again[0], card_ulp[0]]
        sound += readings
        control.append(tf32[0])
        print(f"weight seed {w}: cpu ulp {', '.join(t for _, t in cpu_ulp)}; card {card_fp32[1]}; card again "
              f"{card_again[1]}; card ulp {card_ulp[1]}; tf32 {tf32[1]}; tf32 / largest fp32 "
              f"{tf32[0] / max(readings):.1f}", flush=True)
    print(f"over {args.weight_seeds} weight seeds: largest fp32 reading {max(sound):.3e}, smallest tf32 reading "
          f"{min(control):.3e}, ratio {min(control) / max(sound):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
