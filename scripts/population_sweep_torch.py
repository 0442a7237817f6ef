"""Population sweep: which galaxy population reproduces the reference's
low-SNR baseline fingerprint? (counterpart of ``scripts/population_sweep.py``)

The reference's galaxies are real COSMOS stamps; the simulator's are
parametric Sersic + envelope draws (``data/simulate.py``).  This script
sweeps the population knobs of ``SimulationConfig`` (half-light radius
range, Sersic index range, envelope fraction, knots), renders each with
``simulate_batch_at_snr`` on the device and evaluates the classical
fingerprint methods (No_Deconv, FPFS, Richardson-Lucy(30): no training, so
the comparison is the population alone) at SNR 20/40 against the
reference's committed numbers; the trained flagship (a port checkpoint in
``--trained``) and the transplanted reference ShapeNet (where its ``.pth``
is present) too.

Writes ``--out`` and prints a markdown table.

Usage: python scripts/population_sweep_torch.py [--n_gal 1000] [--device cpu]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig, simulate_batch_at_snr  # noqa: E402
from galaxy_deconv_tpu_torch.eval import make_apply_fn  # noqa: E402
from galaxy_deconv_tpu_torch.metrics import estimate_shear  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import find_checkpoint, restore_checkpoint, unpack_variables  # noqa: E402
from galaxy_deconv_tpu_torch.utils.convert_torch import load_reference_tikhonet  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import resolve_device  # noqa: E402

# the reference's fingerprint (BASELINE.md, results_200 recomputation)
REF = {
    20: {"No_Deconv": 0.0805, "FPFS": 0.1557, "Richard-Lucy(30)": 0.1461,
         "Unrolled_ADMM_Gaussian(8)": 0.0656, "ShapeNet": 0.0766},
    40: {"No_Deconv": 0.0619, "FPFS": 0.0734, "Richard-Lucy(30)": 0.0683,
         "Unrolled_ADMM_Gaussian(8)": 0.0499, "ShapeNet": 0.0534},
    100: {"No_Deconv": 0.0652, "FPFS": 0.0387, "Richard-Lucy(30)": 0.0330,
          "Unrolled_ADMM_Gaussian(8)": 0.0251, "ShapeNet": 0.0276},
    150: {"No_Deconv": 0.0718, "FPFS": 0.0278, "Richard-Lucy(30)": 0.0269,
          "Unrolled_ADMM_Gaussian(8)": 0.0188, "ShapeNet": 0.0207},
    200: {"No_Deconv": 0.0684, "FPFS": 0.0257, "Richard-Lucy(30)": 0.0236,
          "Unrolled_ADMM_Gaussian(8)": 0.0175, "ShapeNet": 0.0225},
}

# config name -> SimulationConfig overrides
CONFIGS = {
    "default": {},
    "no_envelope": dict(env_frac_max=0.0),
    "strong_envelope": dict(env_frac_min=0.5, env_frac_max=0.9),
    "small_gal": dict(hlr_min=0.08, hlr_max=0.4),
    "large_gal": dict(hlr_min=0.2, hlr_max=1.0),
    "cuspy": dict(sersic_n_min=1.0, sersic_n_max=4.0),
    "exponential": dict(sersic_n_min=1.0, sersic_n_max=1.0),
    "large_no_env": dict(hlr_min=0.2, hlr_max=1.0, env_frac_max=0.0),
    # clumpy cores: 4 off-centre Gaussian knots carrying 5-15 % of the flux
    "clumpy": dict(knot_frac_min=0.05, knot_frac_max=0.15),
    "very_clumpy": dict(knot_frac_min=0.15, knot_frac_max=0.35),
}
CLASSICAL = ("No_Deconv", "FPFS", "Richard-Lucy(30)")
FLAGSHIP_RUN = "Gaussian_PnP_ADMM_8iters_MultiScale"
SEED = 31415  # chunk c renders from seed SEED + c


def apply_fns(trained, ref_models, device) -> dict:
    """method -> (obs, psf, alpha) -> rec on the device, for RL(30) and the
    checkpoints found."""
    fns = {"Richard-Lucy(30)": make_apply_fn("Richard-Lucy(30)", device=device)}
    src, ep = find_checkpoint(FLAGSHIP_RUN, trained)
    if ep:
        fns["Unrolled_ADMM_Gaussian(8)"] = make_apply_fn(
            "Unrolled_ADMM_Gaussian(8)", unpack_variables(restore_checkpoint(src, FLAGSHIP_RUN, ep)), device)
    ref_pth = pathlib.Path(ref_models) / "ShapeNet_Laplacian_50epochs.pth"
    if ref_pth.exists():
        fns["ShapeNet"] = make_apply_fn("ShapeNet", load_reference_tikhonet(str(ref_pth)), device)
    return fns


@torch.inference_mode()
def sweep_config(cfg: SimulationConfig, snrs, n_gal: int, chunk: int, fns: dict, device) -> dict:
    """SNR -> method -> median min(|g_rec - g_gt|, 1) over ``n_gal`` galaxies of ``cfg``."""
    dev = resolve_device(device)
    rows = {}
    for snr in snrs:
        errs = {m: [] for m in [*CLASSICAL[:2], *fns]}
        for c in range(0, n_gal, chunk):
            b = simulate_batch_at_snr(SEED + c, chunk, float(snr), cfg, dev)
            obs, psf, gt = b["obs"], b["psf"], b["gt"]
            # alpha = mean(obs), the convention the training and the dataset evaluation use
            alpha = obs.mean(dim=(-2, -1))
            gt_shear = estimate_shear(gt)

            def err(rec_shear):
                return torch.minimum((rec_shear - gt_shear).abs(), torch.ones_like(gt_shear))[:, 2].cpu().numpy()

            errs["No_Deconv"].append(err(estimate_shear(obs)))
            errs["FPFS"].append(err(estimate_shear(obs, psf, deconv_psf=True)))
            for m, fn in fns.items():
                errs[m].append(err(estimate_shear(fn(obs, psf, alpha))))
        rows[snr] = {m: float(np.median(np.concatenate(v))) for m, v in errs.items()}
        line = "  ".join(f"{m}={v:.4f}(ref {REF[snr].get(m, float('nan')):.4f})" for m, v in rows[snr].items())
        print(f"  SNR {snr}: {line}", flush=True)
    return rows


def fingerprint_distance(rows: dict, snrs) -> float:
    """Mean relative error against the reference's classical rows (the population-only signal)."""
    return float(np.mean([abs(rows[s][m] - REF[s][m]) / REF[s][m] for s in snrs for m in CLASSICAL]))


def markdown_table(report: dict, names, snrs) -> str:
    hdr = ["config"] + [f"{m}@{s}" for s in snrs for m in CLASSICAL] + ["dist"]
    lines = ["| " + " | ".join(hdr) + " |", "|" + "---|" * len(hdr),
             "| " + " | ".join(["**reference**"] + [f"**{REF[s][m]:.4f}**" for s in snrs for m in CLASSICAL]
                               + ["0"]) + " |"]
    for name in names:
        rows = report["configs"][name]
        cells = [name] + [f"{rows[s][m]:.4f}" for s in snrs for m in CLASSICAL] + [f"{rows['fingerprint_dist']:.3f}"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_gal", type=int, default=1000)
    parser.add_argument("--chunk", type=int, default=250)
    parser.add_argument("--snrs", type=int, nargs="+", default=[20, 40])
    parser.add_argument("--out", default="figures/population_sweep_torch.json")
    parser.add_argument("--configs", nargs="*", default=None, help="restrict to these config names (default: all)")
    parser.add_argument("--trained", default="trained_torch", help="directory of port checkpoints")
    parser.add_argument("--ref_models", default="reference/saved_models",
                        help="the reference repository's saved_models (its ShapeNet .pth is used where present)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    fns = apply_fns(args.trained, args.ref_models, args.device)
    report = {"n_gal": args.n_gal, "reference": REF, "configs": {}}
    names = args.configs or list(CONFIGS)
    for name in names:
        print(f"{name}:")
        rows = sweep_config(SimulationConfig(**CONFIGS[name]), args.snrs, args.n_gal, args.chunk, fns, args.device)
        rows["fingerprint_dist"] = fingerprint_distance(rows, args.snrs)
        print(f"{name}: fingerprint distance {rows['fingerprint_dist']:.3f}")
        report["configs"][name] = rows

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("\n" + markdown_table(report, names, args.snrs))
    print(f"\nwrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
