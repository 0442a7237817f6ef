"""Cross-estimator consistency check: FPFS against adaptive moments
(counterpart of ``scripts/cross_estimator.py``).

Measures the same images (the benchmark's gt and obs at several SNRs, and
Richardson-Lucy(30) reconstructions of the obs) with the linear-FPFS
estimator (``metrics/shear.py``) and the adaptive-moments one
(``metrics/adaptive_moments.py``) and compares

  * the per-galaxy |g| estimates (correlation, median absolute difference),
  * the benchmark statistic (median ellipticity error against the same
    estimator's gt), i.e. whether the method ranking survives an estimator swap.

The two measure different ellipticity definitions (an FPFS shapelet ratio,
a second-moment ellipticity), so monotone agreement and a consistent
ranking are expected, not pointwise equality.

Usage: python scripts/cross_estimator_torch.py [--n_gal 1000] [--device cpu]
Writes figures/cross_estimator_torch.json.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch.metrics import estimate_shear  # noqa: E402
from galaxy_deconv_tpu_torch.metrics.adaptive_moments import estimate_shear_adaptive  # noqa: E402
from galaxy_deconv_tpu_torch.models import build_model  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device  # noqa: E402

ESTIMATORS = {"fpfs": estimate_shear, "adaptive": estimate_shear_adaptive}


@torch.inference_mode()
def snr_row(gt: np.ndarray, obs: np.ndarray, psf: np.ndarray, device) -> tuple[dict, np.ndarray]:
    """One SNR's statistics on the device, and the RL(30) reconstructions."""
    dev = resolve_device(device)
    gt_t, obs_t, psf_t = (torch.from_numpy(np.array(a, np.float32)).to(dev) for a in (gt, obs, psf))
    with fp32_only():
        rec_t = build_model("Richard-Lucy(30)").to(dev)(obs_t, psf_t, obs_t.mean(dim=(-2, -1)))
    shears = {(est, label): ESTIMATORS[est](imgs).cpu().numpy()
              for est in ESTIMATORS for label, imgs in (("gt", gt_t), ("obs", obs_t), ("rl30", rec_t))}
    row = {}
    for label in ("gt", "obs", "rl30"):
        f, a = shears["fpfs", label], shears["adaptive", label]
        ok = np.isfinite(f[:, 2]) & np.isfinite(a[:, 2])
        row[label] = {
            "corr_g": float(np.corrcoef(f[ok, 2], a[ok, 2])[0, 1]),
            "corr_g1": float(np.corrcoef(f[ok, 0], a[ok, 0])[0, 1]),
            "med_abs_diff_g": float(np.median(np.abs(f[ok, 2] - a[ok, 2]))),
            "fpfs_med_g": float(np.median(f[ok, 2])),
            "adaptive_med_g": float(np.median(a[ok, 2])),
            "n_finite": int(ok.sum()),
        }
    # the benchmark statistic under each estimator: median |g_rec - g_gt|
    for est in ESTIMATORS:
        gg = shears[est, "gt"][:, 2]
        for label, key in (("obs_err", "obs"), ("rl30_err", "rl30")):
            rg = shears[est, key][:, 2]
            ok = np.isfinite(gg) & np.isfinite(rg)
            row[f"{label}_{est}"] = float(np.median(np.minimum(np.abs(rg - gg), 1)[ok]))
    return row, rec_t.cpu().numpy()


def cross_report(data, n_gal: int, snrs, device) -> dict:
    """The report over ``snrs`` for the first ``n_gal`` test galaxies of ``data``."""
    root = pathlib.Path(data)
    psf = np.asarray(np.load(root / "test/psf.npy", mmap_mode="r")[:n_gal], np.float32)
    report = {"n_gal": n_gal, "snrs": {}}
    for snr in snrs:
        gt = np.asarray(np.load(root / f"test/gt_{snr}.npy", mmap_mode="r")[:n_gal], np.float32)
        obs = np.asarray(np.load(root / f"test/obs_{snr}.npy", mmap_mode="r")[:n_gal], np.float32)
        row, _ = snr_row(gt, obs, psf, device)
        report["snrs"][str(snr)] = row
        print(f"SNR {snr}: gt corr={row['gt']['corr_g']:.3f}  rl30 corr={row['rl30']['corr_g']:.3f}  "
              f"err(rl30) fpfs={row['rl30_err_fpfs']:.4f} adaptive={row['rl30_err_adaptive']:.4f}  "
              f"err(obs) fpfs={row['obs_err_fpfs']:.4f} adaptive={row['obs_err_adaptive']:.4f}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_gal", type=int, default=1000)
    ap.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu_10k")
    ap.add_argument("--snrs", type=int, nargs="+", default=[20, 100, 200])
    ap.add_argument("--out", default="figures/cross_estimator_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    report = cross_report(args.data, args.n_gal, args.snrs, args.device)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
