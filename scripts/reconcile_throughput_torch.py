"""Reconcile the bench's throughput with the evaluation harness's on the card
(counterpart of ``scripts/reconcile_throughput.py``).

``cli bench`` times the flagship pipeline at batch 256 on inputs already on
the card; ``cli test``'s sweeps run fp32 at batch 250 from the dataset on
disk.  This script measures the trained flagship's throughput under each
step between the two, so the gap decomposes into its causes:

  A. the evaluation harness as committed  (fp32, batch 250, memmap -> one
     upload per field + slicing on the device, eval/harness.py)
  B. A at the bench's batch size          (fp32, batch 256)
  C. B with the bf16 denoiser             (bf16, batch 256)
  D. C with device-resident inputs        (bench.py's configuration: one
     batch on the card, timed by ``bench.timed_run``)

Each on the host clock, the fetch of the last result inside the window.  The
checkpoint is ``--ckpt_name``'s best in ``--ckpt``, else in ``--trained``.
Writes ``--out`` with the card's name and power limit.

Usage: python scripts/reconcile_throughput_torch.py [--data DIR] [--n_gal 4000] [--device cpu]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch import bench  # noqa: E402
from galaxy_deconv_tpu_torch.data import GalaxyDataset  # noqa: E402
from galaxy_deconv_tpu_torch.eval.harness import _rec_shear_bulk, make_apply_fn  # noqa: E402
from galaxy_deconv_tpu_torch.pipeline import build_pipeline  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import find_checkpoint, restore_checkpoint, unpack_variables  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import card_name_and_power_limit, resolve_device  # noqa: E402

METHOD = "Unrolled_ADMM_Gaussian(8)"
FEATURES = (32, 64, 128, 256)
# label -> (batch, nets' dtype) of the harness configurations
HARNESS_CONFIGS = {"A_eval_harness_fp32_b250": (250, "float32"), "B_plus_batch256": (256, "float32"),
                   "C_plus_bf16": (256, "bfloat16")}
RESIDENT_BATCH = 256  # D, bench.py's batch


def harness_config(state_dict, ds: GalaxyDataset, n_gal: int, batch: int, dtype: str,
                   device) -> tuple[dict, np.ndarray]:
    """The harness's shear sweep of the flagship over the whole batches of the
    first ``n_gal`` galaxies (one batch at least): its row of the report and
    the (n, 3) shears."""
    apply_fn = make_apply_fn(METHOD, state_dict, device, dtype=bench.DTYPES[dtype], features=FEATURES)
    n = max(batch, (n_gal // batch) * batch)
    _rec_shear_bulk(apply_fn, ds, batch, batch, "x", device)  # warm-up
    t0 = time.perf_counter()
    shears = _rec_shear_bulk(apply_fn, ds, n, batch, "x", device)  # returns on the host: the fetch is inside
    dt = time.perf_counter() - t0
    return {"batch": batch, "dtype": dtype, "input": "memmap -> bulk upload + on-device slicing",
            "gal_per_sec": round(shears.shape[0] / dt, 1)}, shears


def resident_config(state_dict, ds: GalaxyDataset, n_gal: int, batch: int, device) -> dict:
    """bench.py's configuration: bf16 nets, one batch on the card, repeated."""
    pipe = build_pipeline(device, dtype=torch.bfloat16, state_dict=state_dict, features=FEATURES)
    b = ds.batch(np.arange(batch))
    reps = max(n_gal // batch, 10)
    seconds, _ = bench.timed_run(pipe, (b["obs"], b["psf"], b["alpha"]), reps)
    return {"batch": batch, "dtype": "bfloat16", "input": "device-resident",
            "gal_per_sec": round(reps * batch / seconds, 1)}


def reconcile(state_dict, data, n_gal: int, device) -> tuple[dict, dict]:
    """Every configuration's row, and the harness configurations' shears."""
    ds = GalaxyDataset(data, "test")
    rows, shears = {}, {}
    for label, (batch, dtype) in HARNESS_CONFIGS.items():
        rows[label], shears[label] = harness_config(state_dict, ds, n_gal, batch, dtype, device)
        print(f"{label}: {rows[label]['gal_per_sec']:.0f} gal/s")
    rows["D_device_resident_bf16_b256"] = resident_config(state_dict, ds, n_gal, RESIDENT_BATCH, device)
    print(f"D_device_resident_bf16_b256: {rows['D_device_resident_bf16_b256']['gal_per_sec']:.0f} gal/s")
    return rows, shears


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu_10k")
    parser.add_argument("--n_gal", type=int, default=4000)
    parser.add_argument("--ckpt_name", default="Gaussian_PnP_ADMM_8iters_MultiScale")
    parser.add_argument("--ckpt", default="saved_models_online_torch", help="checkpoints searched first")
    parser.add_argument("--trained", default="trained_torch", help="port checkpoints searched after --ckpt")
    parser.add_argument("--out", default="figures/throughput_reconciliation_torch.json")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    src, ep = find_checkpoint(args.ckpt_name, args.ckpt, args.trained)
    if not ep:
        raise SystemExit(f"no checkpoint of {args.ckpt_name} in {args.ckpt} or {args.trained}")
    sd = unpack_variables(restore_checkpoint(src, args.ckpt_name, ep))
    rows, _ = reconcile(sd, args.data, args.n_gal, device)

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    report = {"ckpt": f"{src}/{args.ckpt_name}_{ep}epochs", "n_gal": args.n_gal, "configs": rows,
              "device": bench.describe(device),
              "card": card_name_and_power_limit() if device.type == "cuda" else None,
              "clock": "host, from a synchronised device to the last result on the host"}
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
