"""GalSim/COSMOS dataset generation (counterpart of
``galaxy_deconv_tpu/data/generate_galsim.py``, same names).

The port's simulator (:mod:`galaxy_deconv_tpu_torch.data.simulate`) is the
default data source; this module reproduces the reference's GalSim pipeline
(real COSMOS galaxies, GalSim Kolmogorov+OpticalPSF rendering, seed 31415,
the parameter distributions of the reference's ``generate_data.py``) where
``galsim`` and the COSMOS 23.5 catalog are installed, and writes the packed
layout that :class:`~galaxy_deconv_tpu_torch.data.GalaxyDataset` reads.

GalSim draws each PSF and galaxy on the host; the observation step
(:func:`observe`: flux scaling, convolution, downsampling, noise) runs in
torch on the device.  Its noise comes from the caller's numpy ``Generator``,
so one seed gives the JAX package's noise draws.  Import is gated: calling
:func:`generate_cosmos_dataset` without galsim raises a clear error; nothing
else in the port depends on it.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from galaxy_deconv_tpu_torch.data.dataset import write_chunks, write_info
from galaxy_deconv_tpu_torch.data.simulate import noise_sigma
from galaxy_deconv_tpu_torch.ops.resize import average_downsample
from galaxy_deconv_tpu_torch.utils.device import resolve_device


def _require_galsim():
    try:
        import galsim  # noqa: F401

        return galsim
    except ImportError as e:
        raise ImportError(
            "galsim is not installed; use galaxy_deconv_tpu_torch.data.simulate (the "
            "port's own simulator) or install galsim + the COSMOS 23.5 catalog."
        ) from e


def _draw_psf(galsim, rngs, fov_pixels, pixel_scale, upsample, g1_err=0.0, g2_err=0.0, fwhm=None):
    p = rngs
    atmos = galsim.Kolmogorov(fwhm=fwhm if fwhm is not None else p["atmos_fwhm"], flux=1.0)
    atmos = atmos.shear(e=p["atmos_e"], beta=p["atmos_beta"] * galsim.radians)
    optics = galsim.OpticalPSF(
        p["lam_over_diam"],
        defocus=p["defocus"],
        coma1=p["coma1"],
        coma2=p["coma2"],
        astig1=p["astig1"],
        astig2=p["astig2"],
        spher=p["spher"],
        trefoil1=p["trefoil1"],
        trefoil2=p["trefoil2"],
        obscuration=p["obscuration"],
        flux=1.0,
    )
    psf = galsim.Convolve([atmos, optics]).shear(g1=g1_err, g2=g2_err)
    img = galsim.ImageF(fov_pixels * upsample, fov_pixels * upsample)
    psf.drawImage(img, scale=pixel_scale / upsample, method="auto")
    return img.array.astype(np.float32)


def _down(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Average-pool the trailing two axes by ``rate``, on ``x``'s device."""
    return average_downsample(x, rate)


def observe(gal_hi, psf_hi, sigma: float, snr: float, rng: np.random.Generator, upsample: int = 4,
            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The observation step (reference generate_data.py:241-257) on ``device``
    (``None``: the card): scale the flux so ||down(gt)||_2 = snr * sigma,
    convolve at high resolution (rfft2, float64), ifftshift, downsample, clip
    negatives, add N(0, sigma) noise drawn from the numpy ``rng``.

    ``gal_hi`` and ``psf_hi`` are (H, W) arrays or tensors at ``upsample``
    times the stamp's resolution.  Returns float32 (obs, gt) stamps on the
    device, at the downsampled resolution.
    """
    dev = resolve_device("cuda" if device is None else device)
    gal, psf = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (gal_hi, psf_hi))
    alpha = snr * sigma / torch.sqrt((_down(gal, upsample) ** 2).sum())
    gt_hi = alpha * gal
    conv = torch.fft.irfft2(torch.fft.rfft2(psf) * torch.fft.rfft2(gt_hi), s=gt_hi.shape[-2:])
    conv = torch.clamp(_down(torch.fft.ifftshift(conv, dim=(-2, -1)), upsample), min=0.0)
    noise = torch.from_numpy(rng.normal(0.0, sigma, tuple(conv.shape))).to(dev)
    return (conv + noise).float(), _down(gt_hi, upsample).float()


def write_packed_dataset(root, stores, variants, perturbed, meta) -> pathlib.Path:
    """Write the packed ``.npy`` layout that
    :class:`~galaxy_deconv_tpu_torch.data.GalaxyDataset` reads, the files of
    the JAX package's writer byte for byte: per split ``stores[split]``'s
    stacked fields, ``alpha`` = the mean of each obs stamp and zero
    ``snr``/``gal_g1``/``gal_g2``; the fixed-SNR ``variants`` and
    ``perturbed`` PSF sets under ``test/``; ``meta`` as ``info.json``."""
    root = pathlib.Path(root)
    for split, fields in stores.items():
        arrays = {name: np.stack(arrs) for name, arrs in fields.items()}
        n = len(arrays["obs"])
        arrays["alpha"] = arrays["obs"].mean(axis=(1, 2)).astype(np.float32)
        arrays.update({name: np.zeros(n, np.float32) for name in ("snr", "gal_g1", "gal_g2")})
        _write_arrays(root / split, arrays)
    _write_arrays(root / "test", {name: np.stack(arrs) for name, arrs in {**variants, **perturbed}.items()})
    write_info(root, meta)
    return root


def _write_arrays(d: pathlib.Path, arrays: dict) -> None:
    for name, a in arrays.items():
        write_chunks(d, [{name: a}], len(a))


def generate_cosmos_dataset(
    data_path,
    cosmos_dir: str,
    n_train: int = 40000,
    sample: str = "23.5",
    fov_pixels: int = 48,
    pixel_scale: float = 0.2,
    upsample: int = 4,
    seed: int = 31415,
    snrs=(20, 40, 60, 80, 100, 150, 200),
    shear_errs=(0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2),
    fwhm_errs=(0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2),
    device=None,
):
    """Generate the reference's LSST/COSMOS benchmark with GalSim into the
    packed layout.  Parameter distributions follow reference
    generate_data.py:179-235 exactly; each observation is made by
    :func:`observe` on ``device`` (``None``: the card).

    Needs ``galsim`` and the COSMOS 23.5 catalog under ``cosmos_dir``, on
    the machine that runs it: a host with both installed.  Neither the
    port's build box nor its card's machine has them.
    """
    galsim = _require_galsim()
    dev = resolve_device("cuda" if device is None else device)
    root = pathlib.Path(data_path)
    catalog = galsim.RealGalaxyCatalog(dir=cosmos_dir, sample=sample)
    n_total = catalog.nobjects
    sequence = np.arange(n_total)
    np.random.default_rng(seed).shuffle(sequence)

    rng_base = galsim.BaseDeviate(seed=seed)
    rng = galsim.UniformDeviate(seed=seed)
    rng_defocus = galsim.GaussianDeviate(rng_base, mean=0.0, sigma=0.36)
    rng_gauss = galsim.GaussianDeviate(rng_base, mean=0.0, sigma=0.07)
    fwhms = np.array([0.45, 0.55, 0.65, 0.75, 0.85, 0.95])
    freqs = np.array([0.0, 20.0, 17.0, 13.0, 9.0, 0.0])
    tab = galsim.LookupTable(x=fwhms, f=freqs, interpolant="spline")
    xs = np.linspace(fwhms[0], fwhms[-1], 100)
    fs = np.array([tab(x) for x in xs]) / tab.integrate()
    rng_fwhm = galsim.DistDeviate(seed=rng_base, function=galsim.LookupTable(x=xs, f=fs, interpolant="spline"))
    rng_shear = galsim.DistDeviate(seed=rng, function=lambda x: x, x_min=0.01, x_max=0.05)
    rng_snr = galsim.DistDeviate(seed=rng, function=lambda x: 1 / (x**0.7), x_min=18, x_max=220, npoints=1000)

    sigma = noise_sigma(pixel_scale)

    def down_np(x):
        return _down(torch.from_numpy(x), upsample).numpy()

    n_test = n_total - n_train
    stores = {"train": {k: [] for k in ("obs", "psf", "gt")}, "test": {k: [] for k in ("obs", "psf", "gt")}}
    variants = {f"obs_{s}": [] for s in snrs} | {f"gt_{s}": [] for s in snrs}
    perturbed = {f"psf_shear_err_{e}": [] for e in shear_errs} | {f"psf_fwhm_err_{e}": [] for e in fwhm_errs}

    for k in range(n_total):
        idx = int(sequence[k])
        p = dict(
            atmos_fwhm=rng_fwhm(),
            atmos_e=0.01 + 0.02 * rng(),
            atmos_beta=2 * np.pi * rng(),
            defocus=rng_defocus(),
            astig1=rng_gauss(),
            astig2=rng_gauss(),
            coma1=rng_gauss(),
            coma2=rng_gauss(),
            spher=rng_gauss(),
            trefoil1=rng_gauss(),
            trefoil2=rng_gauss(),
            obscuration=0.1 + 0.4 * rng(),
            lam_over_diam=0.017 + 0.007 * rng(),
        )
        psf_hi = _draw_psf(galsim, p, fov_pixels, pixel_scale, upsample)

        gal = galsim.RealGalaxy(catalog, index=idx)
        gal = gal.rotate(2 * np.pi * rng() * galsim.radians)
        gal = gal.shear(g=rng_shear(), beta=2 * np.pi * rng() * galsim.radians)
        gal = gal.magnify(1 + rng() * 0.1)
        img = galsim.ImageF(fov_pixels * upsample, fov_pixels * upsample)
        gal = galsim.Convolve([catalog.getPSF(idx), gal])
        gal.drawImage(img, scale=pixel_scale / upsample, offset=(2 * rng() - 1, 2 * rng() - 1), method="auto")
        gal_hi = torch.from_numpy(np.maximum(img.array.astype(np.float32), 0.0)).to(dev)
        psf_dev = torch.from_numpy(psf_hi).to(dev)

        def observe_at(snr_val, rng_np):
            obs, gt = observe(gal_hi, psf_dev, sigma, snr_val, rng_np, upsample, dev)
            return obs.cpu().numpy(), gt.cpu().numpy()

        rng_np = np.random.default_rng(seed + k)
        obs, gt = observe_at(rng_snr(), rng_np)
        split = "train" if k < n_train else "test"
        stores[split]["obs"].append(obs)
        stores[split]["psf"].append(down_np(psf_hi))
        stores[split]["gt"].append(gt)

        if k >= n_train:
            for s in snrs:
                o, g = observe_at(s, rng_np)
                variants[f"obs_{s}"].append(o)
                variants[f"gt_{s}"].append(g)
            for e in shear_errs:
                g1e = e if rng() > 0.5 else -e
                g2e = e if rng() > 0.5 else -e
                perturbed[f"psf_shear_err_{e}"].append(
                    down_np(_draw_psf(galsim, p, fov_pixels, pixel_scale, upsample, g1e, g2e))
                )
            for e in fwhm_errs:
                f = p["atmos_fwhm"] + (e if rng() > 0.5 else -e)
                f = f + 2 * e if f < 0 else f
                perturbed[f"psf_fwhm_err_{e}"].append(
                    down_np(_draw_psf(galsim, p, fov_pixels, pixel_scale, upsample, fwhm=f))
                )

    meta = dict(n_train=n_train, n_test=n_test, fov_pixels=fov_pixels, pixel_scale=pixel_scale,
                upsample=upsample, seed=seed, snrs=list(snrs), shear_errs=list(shear_errs),
                fwhm_errs=list(fwhm_errs), generator="galsim/COSMOS")
    return write_packed_dataset(root, stores, variants, perturbed, meta)
