"""bf16-against-fp32 accuracy of the trained flagship, in both packages, on
the same galaxies (the port's counterpart of ``scripts/bf16_parity.py``).

Loads the trained flagship checkpoint (``trained/Gaussian_PnP_ADMM_8iters_MultiScale_*``,
the best-validation step) with the JAX package and carries it into the port
through the weight bridge; runs both packages' flagship with the
denoiser/SubNet in float32 and in bfloat16 (the FFT solves stay float32) on
the first ``--n_gal`` test galaxies of ``--data`` at each of ``--snrs``,
through each package's harness on the CPU; and writes the per-SNR median of
min(||g_rec| - |g_gt||, 1) of each package and dtype, beside
``figures/bf16_parity.json``'s (JAX's medians on the TPU rounds' own 10k
dataset, so a population check only: the port's simulator streams are not
JAX's), to ``--out``.

This is a cross-check that needs JAX, flax and orbax (the checkpoint is an
orbax file), like the tests; it runs on the CPU where the JAX package runs,
not on the card's machine.  The galaxies come from the port's
``python -m galaxy_deconv_tpu_torch generate --device cpu``.

Usage: python scripts/bf16_parity_torch.py --data DIR [--n_gal 2000] [--batch 250]
           [--snrs 20 100 200] [--out figures/bf16_parity_torch.json]
"""

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

METHOD = "Unrolled_ADMM_Gaussian(8)"


def median_error(rec, gt) -> float:
    import numpy as np

    return float(np.median(np.minimum(np.abs(rec[:, 2] - gt[: len(rec), 2]), 1)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu_10k")
    ap.add_argument("--n_gal", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=250)
    ap.add_argument("--snrs", type=int, nargs="+", default=[20, 100, 200])
    ap.add_argument("--ckpt", default=str(REPO / "trained"))
    ap.add_argument("--ckpt_name", default="Gaussian_PnP_ADMM_8iters_MultiScale")
    ap.add_argument("--reference", default=str(REPO / "figures" / "bf16_parity.json"))
    ap.add_argument("--out", default="figures/bf16_parity_torch.json")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from galaxy_deconv_tpu.data.dataset import GalaxyDataset as JDataset
    from galaxy_deconv_tpu.eval.harness import _batched_rec_shear
    from galaxy_deconv_tpu.eval.harness import make_apply_fn as jmake_apply_fn
    from galaxy_deconv_tpu.metrics import estimate_shear as jestimate_shear
    from galaxy_deconv_tpu.train.checkpoint import best_epoch, restore_checkpoint, unpack_variables
    from galaxy_deconv_tpu_torch.data import GalaxyDataset
    from galaxy_deconv_tpu_torch.eval.harness import _rec_shear_bulk, make_apply_fn
    from galaxy_deconv_tpu_torch.metrics import estimate_shear
    from galaxy_deconv_tpu_torch.utils import model_state_dict

    ep = best_epoch(args.ckpt, args.ckpt_name)
    variables = jax.tree.map(np.asarray, unpack_variables(restore_checkpoint(args.ckpt, args.ckpt_name, ep)))
    state_dict = model_state_dict(variables["params"], variables["batch_stats"])
    ckpt = f"{pathlib.Path(args.ckpt).name}/{args.ckpt_name}_{ep}"
    print(f"flagship checkpoint: {ckpt}; data {args.data}; {args.n_gal} galaxies; torch threads "
          f"{torch.get_num_threads()}", flush=True)

    # the tree by its name and its generator's record (seed, sizes, optics), not by where it sits
    info = json.loads((pathlib.Path(args.data) / "info.json").read_text())
    report = {"ckpt": ckpt, "data": pathlib.Path(args.data).name, "data_info": info, "n_gal": args.n_gal,
              "device": "cpu", "metric": "median over galaxies of min(||g_rec| - |g_gt||, 1)", "rows": {}}
    for dtype in ("float32", "bfloat16"):
        japply = jmake_apply_fn(METHOD, variables, dtype=jnp.dtype(dtype))
        tapply = make_apply_fn(METHOD, state_dict, device="cpu", dtype=getattr(torch, dtype))
        for snr in args.snrs:
            row = report["rows"].setdefault(str(snr), {"port": {}, "jax": {}})
            t0 = time.perf_counter()
            ds = GalaxyDataset(args.data, "test", obs_variant=f"obs_{snr}")
            gt = torch.from_numpy(np.array(ds.gt[: args.n_gal], np.float32))
            with torch.inference_mode():
                gt_shear = estimate_shear(gt).numpy()
            rec = _rec_shear_bulk(tapply, ds, min(args.n_gal, len(ds)), args.batch, METHOD, "cpu")
            row["port"][dtype] = median_error(rec, gt_shear)
            t1 = time.perf_counter()
            jds = JDataset(args.data, "test", obs_variant=f"obs_{snr}")
            jgt = np.asarray(jestimate_shear(jnp.asarray(np.array(jds.gt[: args.n_gal], np.float32))))
            jrec = _batched_rec_shear(japply, jds, args.n_gal, args.batch, METHOD)
            row["jax"][dtype] = median_error(jrec, jgt)
            print(f"{dtype:9s} snr={snr:3d}: median err port {row['port'][dtype]:.4f} ({t1 - t0:.0f} s), "
                  f"jax {row['jax'][dtype]:.4f} ({time.perf_counter() - t1:.0f} s)", flush=True)

    ref = pathlib.Path(args.reference)
    if ref.exists():
        report["reference_figure"] = {"file": str(ref.relative_to(REPO) if ref.is_relative_to(REPO) else ref),
                                      **json.loads(ref.read_text())}
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
