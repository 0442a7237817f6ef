"""Draw the benchmark's figures from the port's results (counterpart of
``scripts/make_figures.py``).

  <out>/error_snr_torch.png        median ellipticity error vs SNR
  <out>/error_time_torch.png       accuracy-vs-speed scatter
  <out>/psf_shear_error_torch.png  robustness to PSF shear systematics
  <out>/psf_fwhm_error_torch.png   robustness to PSF FWHM systematics
  <out>/gallery_torch.png          obs / reconstruction / gt stamp gallery
  <out>/admm_trace_torch.png       per-iteration x/z estimates + rho schedule

The four results figures come from a results directory (what
``scripts/run_benchmark_torch.py`` writes).  The gallery and the trace come
from the flagship's latest port checkpoint in ``--ckpt`` and a dataset:
:func:`model_arrays` computes their arrays on the device (one
``analysis=True`` forward, whose last z is the model's output) and
:func:`draw_model_figures` draws them, so the arrays can be computed where
matplotlib is not installed.

Usage: python scripts/make_figures_torch.py [--result results_torch] [--out figures]
       [--device cpu] [--skip_model]  (the gallery and trace need a dataset and a checkpoint)
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data import GalaxyDataset  # noqa: E402
from galaxy_deconv_tpu_torch.eval import DEFAULT_PSF_ERRS  # noqa: E402
from galaxy_deconv_tpu_torch.models import build_model  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import latest_epoch, restore_checkpoint, unpack_variables  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device  # noqa: E402

FLAGSHIP_RUN = "Gaussian_PnP_ADMM_8iters_MultiScale"
FEATURES = (32, 64, 128, 256)


def results_figures(result, out, snr: int) -> list:
    """The four results figures of the methods with results under ``result``."""
    from galaxy_deconv_tpu_torch.analysis import plot_error_vs_snr, plot_error_vs_time, plot_psf_error

    result, out = pathlib.Path(result), pathlib.Path(out)
    methods = sorted(p.name for p in result.iterdir() if (p / "results.json").exists())
    written = [out / "error_snr_torch.png", out / "error_time_torch.png"]
    plot_error_vs_snr(result, methods, save_to=written[0])
    plot_error_vs_time(result, methods, snr=snr, save_to=written[1])
    for kind in ("shear", "fwhm"):
        robust = [m for m in methods if (result / m / f"results_psf_{kind}_err.json").exists()]
        if robust:
            written.append(out / f"psf_{kind}_error_torch.png")
            plot_psf_error(result, robust, DEFAULT_PSF_ERRS, kind=kind, save_to=written[-1])
    return written


def model_arrays(state_dict: dict, data, snr: int, device, n: int = 6) -> dict:
    """The gallery's and the trace's arrays: the first ``n`` test galaxies at
    SNR ``snr`` (obs, gt) and one ``analysis=True`` forward of the flagship
    with ``state_dict`` (its x, z, u, rho per iteration, (n, 8, ...)), as numpy."""
    ds = GalaxyDataset(data, "test", obs_variant=f"obs_{snr}")
    b = ds.batch(np.arange(n))
    dev = resolve_device(device)
    model = build_model("Unrolled_ADMM_Gaussian(8)", analysis=True, features=FEATURES)
    model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    with torch.inference_mode(), fp32_only():
        traces = model(*(torch.from_numpy(b[k]).to(dev) for k in ("obs", "psf", "alpha")))
    return {"obs": b["obs"], "gt": b["gt"], "traces": {k: v.cpu().numpy() for k, v in traces.items()}}


def draw_model_figures(arrays: dict, out) -> list:
    """The gallery (observed, the last iteration's z, ground truth) and the
    trace of the first galaxy."""
    from galaxy_deconv_tpu_torch.analysis import plot_admm_trace, plot_reconstruction_grid

    out = pathlib.Path(out)
    written = [out / "gallery_torch.png", out / "admm_trace_torch.png"]
    traces = arrays["traces"]
    plot_reconstruction_grid({"observed": arrays["obs"], "ADMM(8)": traces["z"][:, -1], "ground truth": arrays["gt"]},
                             save_to=written[0])
    plot_admm_trace(traces, sample=0, save_to=written[1])
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--result", default="results_torch")
    parser.add_argument("--out", default="figures")
    parser.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu")
    parser.add_argument("--ckpt", default="trained_torch", help="directory of port checkpoints")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--skip_model", action="store_true",
                        help="results-only figures (no dataset/checkpoint needed)")
    parser.add_argument("--snr", type=int, default=100)
    args = parser.parse_args(argv)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results_figures(args.result, out, args.snr)
    print(f"results figures -> {out}")
    if args.skip_model:
        return 0
    ep = latest_epoch(args.ckpt, FLAGSHIP_RUN)
    if not ep or not pathlib.Path(args.data).exists():
        print("no checkpoint/dataset — skipping gallery + trace figures")
        return 0
    sd = unpack_variables(restore_checkpoint(args.ckpt, FLAGSHIP_RUN, ep))
    draw_model_figures(model_arrays(sd, args.data, args.snr, args.device), out)
    print(f"model figures -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
