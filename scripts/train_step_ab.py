"""Time the port's disk train step in two source trees, in turns, on one card.

    python scripts/train_step_ab.py --base DIR [--change .] [--pairs 5]

Each tree is a checkout of the repository (for example an older commit
unpacked with ``git archive``).  The script runs ``--pairs`` rounds of four
processes, base, change, change, base, so that a drift of the card's clocks
over the run falls on both sides alike.  Each process builds the full-width
flagship (8 iterations, features 32-256, weights from seed 0) with that tree's
package, takes 25 train steps of ``make_train_step`` on one batch of 32 of
``chip_smoke.write_dataset``'s stamps, waiting for the card around each step
as ``chip_smoke.py`` phase 6 (d) does, and reports the median of the last 20.  It prints one line per process, then the card's name
and power limit, then a JSON summary: every reading of each side and the
differences change - base of each round's two means.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

STEPS, WARM = 25, 5
# run inside each tree: only what chip_smoke.py and the package have had since the train step was ported
TIMER = r"""
import json, pathlib, sys, tempfile, time
import numpy as np
import torch
import chip_smoke as cs
from galaxy_deconv_tpu_torch.data import GalaxyDataset
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.train import create_train_state, make_train_step

steps, warm = int(sys.argv[1]), int(sys.argv[2])
device = torch.device("cuda")
with tempfile.TemporaryDirectory() as tmp:
    ds = GalaxyDataset(cs.write_dataset(pathlib.Path(tmp) / "data"))
    batch = ds.batch(np.arange(cs.TRAIN_BATCH))
model = UnrolledADMMGaussian(**cs.FLAGSHIP).to(device)
state, optimizer = create_train_state(model, 0)
step = make_train_step(model, MultiScaleLoss(), optimizer)
times = []
for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(float(loss)):
        raise SystemExit("a train step's loss is not finite")
print(json.dumps({"step_ms": float(np.median(times[warm:])), "times": times[warm:]}))
"""


def time_tree(tree: pathlib.Path) -> float:
    res = subprocess.run([sys.executable, "-c", TIMER, str(STEPS), str(WARM)], cwd=tree, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"the timer failed in {tree} (exit {res.returncode}):\n{res.stdout}\n{res.stderr}")
    reading = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"{tree}: {reading['step_ms']:.2f} ms per step (median of {len(reading['times'])}: "
          + ", ".join(f"{t:.2f}" for t in reading["times"]) + ")", flush=True)
    return reading["step_ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, required=True, help="the tree to compare against")
    ap.add_argument("--change", type=pathlib.Path, default=pathlib.Path("."), help="the changed tree")
    ap.add_argument("--pairs", type=int, default=5, help="rounds of base, change, change, base")
    args = ap.parse_args()
    trees = {"base": args.base.resolve(), "change": args.change.resolve()}
    readings = {"base": [], "change": []}
    diffs = []
    for _ in range(args.pairs):
        got = {side: [] for side in trees}
        for side in ("base", "change", "change", "base"):
            got[side].append(time_tree(trees[side]))
        for side in trees:
            readings[side] += got[side]
        diffs.append(sum(got["change"]) / 2 - sum(got["base"]) / 2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"base_ms": readings["base"], "change_ms": readings["change"], "change_minus_base_ms": diffs,
                      "median_difference_ms": sorted(diffs)[len(diffs) // 2]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
