"""Tutorial: build one simulated LSST observation step by step, with the
PyTorch port (counterpart of ``examples/simulation_walkthrough.py``).

Samples PSF and galaxy parameters, renders the atmospheric/optical PSF and
the Sersic galaxy at 4x resolution, FFT-convolves, downsamples to the 48x48
LSST field of view, adds CCD noise, and shows every intermediate product:
a figure when matplotlib is installed, else the arrays in an ``.npz`` beside
the figure's name.

Run:  python examples/simulation_walkthrough_torch.py [--out figures/simulation_walkthrough_torch.png]
          [--seed 7] [--snr 100] [--device cpu]
(it runs on the card unless --device cpu)
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def save_panels(panels: list, out: pathlib.Path) -> pathlib.Path:
    """A row of images with titles at ``out`` or, without matplotlib, the
    arrays in ``out`` with the suffix ``.npz``; the path written."""
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        import matplotlib
    except ImportError:
        out = out.with_suffix(".npz")
        np.savez(out, **{title.replace(" ", "_"): img for title, img in panels})
        print("matplotlib is not installed: the panels' arrays go to an .npz instead of a figure")
        return out
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(panels), figsize=(3 * len(panels), 3))
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img, cmap="magma", origin="lower")
        ax.set_title(title, fontsize=10)
        ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="figures/simulation_walkthrough_torch.png")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--snr", type=float, default=100.0)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from galaxy_deconv_tpu_torch.data.simulate import (SimulationConfig, chunk_generators, draw_noise, noise_sigma,
                                                       observe, render_galaxy, render_psf, sample_params)
    from galaxy_deconv_tpu_torch.metrics import estimate_shear
    from galaxy_deconv_tpu_torch.ops.resize import average_downsample
    from galaxy_deconv_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = SimulationConfig()
    pgen, ngen, _ = chunk_generators(args.seed, device)
    params = sample_params(pgen, 1, cfg)

    print(f"device: {device}")
    print("sampled parameters:")
    for k in ("atmos_fwhm", "atmos_e", "gal_g", "gal_beta", "sersic_n", "half_light_radius"):
        print(f"  {k:17s} = {float(params[k][0]):+.4f}")

    # 1. PSF at 4x resolution: analytic Kolmogorov MTF x pupil-plane Zernike
    #    optics (reference generate_data.py get_LSST_PSF, :16-69)
    psf_hi = render_psf(params, cfg)

    # 2. Sheared Sersic galaxy at 4x resolution (reference get_COSMOS_Galaxy, generate_data.py:72-111)
    gal_hi = render_galaxy(params, cfg)

    # 3. Flux scaling to the target SNR: alpha = snr * sigma / ||gal||_2 at
    #    fov resolution (reference generate_data.py:241-244)
    sigma = noise_sigma(cfg.pixel_scale)
    gal_fov = average_downsample(gal_hi, cfg.upsample)
    alpha = args.snr * sigma / torch.sqrt((gal_fov**2).sum())
    gt_hi = alpha * gal_hi
    gt = alpha * gal_fov

    # 4. Convolve + 4x downsample + CCD noise (generate_data.py:246-257)
    obs = observe(gt_hi, psf_hi, draw_noise(ngen, 1, cfg), cfg)
    psf = average_downsample(psf_hi, cfg.upsample)

    g = estimate_shear(gt)[0].cpu().numpy()
    g1 = float(params["gal_g"][0] * torch.cos(2 * params["gal_beta"][0]))
    g2 = float(params["gal_g"][0] * torch.sin(2 * params["gal_beta"][0]))
    snr = float(torch.sqrt((gt**2).sum())) / sigma
    print(f"\ntrue shear (g1, g2) = ({g1:+.4f}, {g2:+.4f})")
    print(f"measured on gt stamp: ({g[0]:+.4f}, {g[1]:+.4f})")
    print(f"stamp SNR = ||gt||/sigma = {snr:.1f} (target {args.snr})")

    panels = [(title, img[0].cpu().numpy()) for title, img in (
        ("PSF (4x res)", psf_hi), ("galaxy (4x res)", gt_hi), ("PSF (fov)", psf), ("ground truth (fov)", gt),
        ("observation", obs))]
    out = save_panels(panels, pathlib.Path(args.out))
    print(f"\nwrote {out}")
    return {"panels": dict(panels), "true_shear": (g1, g2), "gt_shear": g, "snr": snr, "out": out}


if __name__ == "__main__":
    main()
