"""The SubNet rho schedule and the effective unrolled depth of the trained
flagship variants (counterpart of ``scripts/rho_trace.py``).

Runs each UnrolledADMMGaussian checkpoint found in ``analysis=True`` mode
over a batch of random-SNR test galaxies and records the population
statistics of the per-iteration penalty rho that the SubNet picks, and the
per-iteration progress of the iterate (the relative change of z), which
measures the effective unrolled depth: an iteration whose rho is ~1e-6
leaves z nearly where it was.  :func:`schedule_stats` computes them from the
traces; :func:`draw` plots them, so the statistics can be computed where
matplotlib is not installed.

Outputs:
  <out>/rho_schedule_torch.json   per-iteration rho quantiles + z-progress stats
  <out>/rho_schedule_torch.png    log-rho schedule, unbounded vs bounded variants

Usage: python scripts/rho_trace_torch.py [--data DIR] [--batch 128] [--device cpu]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data import GalaxyDataset  # noqa: E402
from galaxy_deconv_tpu_torch.models import build_model  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import find_checkpoint, restore_checkpoint, unpack_variables  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device  # noqa: E402

# result label -> (build name, checkpoint run name)
SPECS = {
    "Unrolled_ADMM_Gaussian(8)": ("Unrolled_ADMM_Gaussian(8)", "Gaussian_PnP_ADMM_8iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(4)": ("Unrolled_ADMM_Gaussian(4)", "Gaussian_PnP_ADMM_4iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(2)": ("Unrolled_ADMM_Gaussian(2)", "Gaussian_PnP_ADMM_2iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(8)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(8)",
                                          "Gaussian_PnP_ADMM_8iters_Bounded_MultiScale"),
    "Unrolled_ADMM_Gaussian(4)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(4)",
                                          "Gaussian_PnP_ADMM_4iters_Bounded_MultiScale"),
    "Unrolled_ADMM_Gaussian(2)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(2)",
                                          "Gaussian_PnP_ADMM_2iters_Bounded_MultiScale"),
}
FEATURES = (32, 64, 128, 256)


def model_traces(build_name: str, state_dict: dict, batch: dict, device) -> dict:
    """The (B, n_iters, ...) x, z, u and rho traces of one ``analysis=True``
    forward on ``batch`` (numpy obs, psf, alpha), as float32 numpy."""
    dev = resolve_device(device)
    model = build_model(build_name, analysis=True, features=FEATURES)
    model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    with torch.inference_mode(), fp32_only():
        traces = model(*(torch.from_numpy(np.asarray(batch[k], np.float32)).to(dev) for k in ("obs", "psf", "alpha")))
    return {k: v.cpu().numpy() for k, v in traces.items()}


def schedule_stats(traces: dict) -> dict:
    """Per-iteration rho quantiles (10 %, median, 90 %) over the galaxies, the
    median relative change of z at iterations 2..n, and the effective depth:
    1 plus the iterations that move z by more than 1 % of its norm."""
    rho = np.asarray(traces["rho"])[..., 0, 0]  # (B, n)
    z = np.asarray(traces["z"], np.float64)  # (B, n, H, W)
    # step 0 is measured against the Wiener initialisation, which the traces
    # do not record: the n-1 deltas of steps 1..n-1
    dz = np.linalg.norm(np.diff(z, axis=1), axis=(2, 3))
    zn = np.linalg.norm(z[:, 1:], axis=(2, 3))
    rel_dz = dz / np.maximum(zn, 1e-12)  # (B, n-1)
    active = (rel_dz > 0.01).sum(axis=1) + 1  # the first step always counts
    return {
        "rho_q10": np.quantile(rho, 0.10, axis=0).tolist(),
        "rho_median": np.median(rho, axis=0).tolist(),
        "rho_q90": np.quantile(rho, 0.90, axis=0).tolist(),
        "rel_z_change_median": np.median(rel_dz, axis=0).tolist(),
        "effective_iters_median": float(np.median(active)),
        "effective_iters_mean": float(active.mean()),
    }


def trace_report(data, batch_size: int, ckpt, trained, device) -> dict:
    """The report of every variant found: its checkpoint and its statistics."""
    b = GalaxyDataset(data, "test").batch(np.arange(batch_size))  # random-SNR observations
    report = {"data": str(data), "batch": batch_size, "models": {}}
    for label, (build_name, ckpt_name) in SPECS.items():
        src, ep = find_checkpoint(ckpt_name, ckpt, trained)
        if not ep:
            print(f"{label}: no checkpoint, skipping")
            continue
        sd = unpack_variables(restore_checkpoint(src, ckpt_name, ep))
        stats = schedule_stats(model_traces(build_name, sd, b, device))
        report["models"][label] = {"ckpt": f"{src}/{ckpt_name}_{ep}epochs", **stats}
        med = ", ".join(f"{v:.3g}" for v in stats["rho_median"])
        print(f"{label} (step {ep}): median rho per iter = [{med}]; "
              f"effective iters (median) = {stats['effective_iters_median']:.1f}")
    return report


def draw(report: dict, path) -> None:
    """The schedule (median and 10-90 % band, log scale) and the z progress of each variant."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for label, stats in report["models"].items():
        n = len(stats["rho_median"])
        it = np.arange(1, n + 1)
        style = dict(marker="o", ls="--" if "bounded" in label else "-")
        line, = axes[0].plot(it, stats["rho_median"], label=label, **style)
        axes[0].fill_between(it, stats["rho_q10"], stats["rho_q90"], alpha=0.15, color=line.get_color())
        axes[1].plot(np.arange(2, n + 1), stats["rel_z_change_median"], label=label, color=line.get_color(), **style)
    axes[0].set_yscale("log")
    axes[0].set_xlabel("unrolled iteration")
    axes[0].set_ylabel(r"SubNet $\rho_i$ (median, 10-90%)")
    axes[0].axhspan(0.1, 10.0, color="0.9", zorder=0, label=r"bounded $\rho$ range")
    axes[1].set_yscale("log")
    axes[1].set_xlabel("unrolled iteration")
    axes[1].set_ylabel(r"median $\|z_i - z_{i-1}\| / \|z_i\|$")
    axes[1].axhline(0.01, color="0.6", lw=0.8, ls=":")
    axes[0].legend(fontsize=7)
    fig.suptitle("SubNet penalty schedule and effective unrolled depth")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu_10k")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", default="figures")
    parser.add_argument("--ckpt", default="saved_models_online_torch", help="checkpoints searched first")
    parser.add_argument("--trained", default="trained_torch", help="port checkpoints searched after --ckpt")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    report = trace_report(args.data, args.batch, args.ckpt, args.trained, args.device)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "rho_schedule_torch.json", "w") as f:
        json.dump(report, f, indent=1)
    draw(report, out / "rho_schedule_torch.png")
    print(f"wrote {out}/rho_schedule_torch.json and {out}/rho_schedule_torch.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
