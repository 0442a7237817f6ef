"""LSST-like galaxy image simulation on the device (counterpart of
``galaxy_deconv_tpu/data/simulate.py``; see that module for the physics).

Per sample: an atmospheric Kolmogorov PSF with the empirical seeing
distribution, sheared by a small distortion; an optical PSF from an obscured
pupil with Noll Zernike aberrations, as the pupil's autocorrelation sampled
bilinearly on the image's frequency grid; a parametric Sersic galaxy (with an
exponential envelope and optional knots) lensed, rotated, magnified, offset
and convolved with an HST-like Gaussian; the observation as the FFT
convolution at 4x upsampling, 4x average downsampling and Gaussian CCD noise,
the flux scaled to the drawn SNR.

Each ``simulate_*`` is two steps, so that a test can hand the renderers the
JAX package's own draws:

1. draw: :func:`sample_params`, :func:`draw_noise`, :func:`draw_signs`, each
   from its own ``torch.Generator`` of :func:`chunk_generators`;
2. render from the draws: :func:`render_batch`, :func:`render_perturbed_psfs`,
   :func:`render_batch_denoise` (the denoising task, its SNR from
   :func:`draw_denoise_snr`).

Random streams.  ``torch``'s generators cannot reproduce ``jax.random``'s
streams, so a dataset made here from ``--seed`` is not the JAX package's
dataset for that seed; the distributions are the same.  What the JAX
generator relies on is kept: one integer seed per chunk gives three
generators (parameters, noise, PSF-error signs), so ``simulate_batch``,
``simulate_batch_at_snr`` and ``simulate_perturbed_psfs`` of one seed share
the same scenes, and the first two the same noise draw.  A CUDA generator and
a CPU generator of one seed give different draws, so the same seed rebuilds
the same dataset only on the same kind of device.

Renderers take batched parameter dicts ((B,) tensors, (B, K) for the knots)
and return (B, ...) tensors on the parameters' device.  The grids that do not
depend on the sample (pupil radius and angle, the eight Zernike polynomials,
frequency grids, phase ramps) are built once per configuration and device.
The pupil's autocorrelation, 8 MB per sample at ``pupil_pad`` 1024, is
computed ``_sub_batch(cfg)`` samples at a time.  Against the JAX package's
per-sample renders on the same draws, the precomputed grids and batched sums
round differently in float32: renders agree within 1e-5 of their peak
(``tests/test_torch_simulate.py``; the CPU reads 2e-7 to 6e-7).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from galaxy_deconv_tpu_torch.ops.resize import average_downsample

# ---------------------------------------------------------------------------
# CCD / sky constants (reference generate_data.py:194-202)
# ---------------------------------------------------------------------------

CCD = dict(
    exp_time=30.0,  # s (2x15s visits)
    sky_brightness=20.48,  # i-band AB mag / arcsec^2
    zero_point=27.85,  # AB mag producing 1 e-/s
    gain=2.3,  # e-/ADU
    qe=0.94,
    read_noise=8.8,  # e-/pixel
)


def get_flux(ab_magnitude: float, exp_time: float, zero_point: float, gain: float, qe: float) -> float:
    """AB magnitude -> flux in ADU/arcsec^2 (reference utils/utils_data.py:10-23)."""
    return exp_time * zero_point * 10 ** (-0.4 * (ab_magnitude - 24)) * qe / gain


def noise_sigma(pixel_scale: float = 0.2) -> float:
    """Total per-pixel Gaussian noise sigma in ADU (sky + read)."""
    sky_level_pixel = (
        get_flux(CCD["sky_brightness"], CCD["exp_time"], CCD["zero_point"], CCD["gain"], CCD["qe"])
        * pixel_scale**2
    )
    return float(np.sqrt(sky_level_pixel + (CCD["read_noise"] * CCD["qe"] / CCD["gain"]) ** 2))


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """The JAX package's configuration, field for field (see its docstrings)."""

    fov_pixels: int = 48
    pixel_scale: float = 0.2  # arcsec / output pixel
    upsample: int = 4
    pupil_n: int = 512  # samples across the pupil diameter
    pupil_pad: int = 1024  # FFT grid for the pupil autocorrelation
    hst_fwhm: float = 0.1  # arcsec, HST-like pre-convolution of galaxies
    snr_min: float = 18.0
    snr_max: float = 220.0
    snr_power: float = 0.7  # p(snr) ∝ snr^-power
    # parametric galaxies: hlr log-uniform, Sersic index and axis ratio uniform
    hlr_min: float = 0.12
    hlr_max: float = 0.7
    sersic_n_min: float = 0.5
    sersic_n_max: float = 1.5
    q_int_min: float = 0.25
    # diffuse exponential envelope around the core
    env_frac_min: float = 0.0
    env_frac_max: float = 0.8
    env_size_ratio: float = 4.0
    env_ellip_ratio: float = 0.5
    # clumpy-core knots, off by default (knot_frac_max = 0)
    n_knots: int = 4
    knot_frac_min: float = 0.0
    knot_frac_max: float = 0.0
    knot_sigma: float = 0.05
    knot_r_scale: float = 0.6

    @property
    def n_hi(self) -> int:
        return self.fov_pixels * self.upsample

    @property
    def scale_hi(self) -> float:
        return self.pixel_scale / self.upsample


# ---------------------------------------------------------------------------
# Shear algebra and the atmosphere
# ---------------------------------------------------------------------------


def reduced_shear_matrix(g1, g2) -> torch.Tensor:
    """Area-preserving shear matrix mapping source -> image coordinates,
    (..., 2, 2) for (...) shears."""
    g1, g2 = torch.as_tensor(g1, dtype=torch.float32), torch.as_tensor(g2, dtype=torch.float32)
    norm = 1.0 / torch.sqrt(torch.clamp_min(1.0 - g1**2 - g2**2, 1e-8))
    m = torch.stack([torch.stack([1.0 + g1, g2], -1), torch.stack([g2, 1.0 - g1], -1)], -2)
    return norm[..., None, None] * m


def distortion_to_g(e):
    """Distortion |e| -> reduced shear |g| (e = 2g/(1+g^2))."""
    return e / (1.0 + torch.sqrt(torch.clamp_min(1.0 - e**2, 0.0)))


_KOLM_FWHM_RATIO = 0.975865  # FWHM = 0.976 lambda/r0 for Kolmogorov


def kolmogorov_mtf(nu_x, nu_y, fwhm):
    """Long-exposure Kolmogorov MTF exp(-3.44 (lambda nu / r0)^{5/3}) by FWHM
    (arcsec); nu in cycles/arcsec."""
    lam_over_r0 = fwhm / _KOLM_FWHM_RATIO
    nu = torch.sqrt(nu_x**2 + nu_y**2)
    return torch.exp(-3.44 * (lam_over_r0 * nu) ** (5.0 / 3.0))


# ---------------------------------------------------------------------------
# Sample-independent grids
# ---------------------------------------------------------------------------


_TWO_PI = float(np.float32(2 * np.pi))  # 2 pi as float32 rounds it, as in the JAX package's phases


def _fftfreq(n: int, d: float = 1.0, real: bool = False) -> torch.Tensor:
    """``jnp.fft.fftfreq`` / ``rfftfreq`` in float32: integer k over float32(d n)."""
    k = np.arange(n // 2 + 1) if real else (np.arange(n) + n // 2) % n - n // 2
    return torch.from_numpy(k.astype(np.float32)) / torch.tensor(d * n, dtype=torch.float32)


def _freq_grid(n: int, scale: float, device=None):
    """rfft2 frequency grid (cycles/arcsec) for an (n, n) image: (NUY, NUX),
    each (n, n//2+1)."""
    fy, fx = _fftfreq(n, scale), _fftfreq(n, scale, real=True)
    return tuple(g.to(device) for g in torch.meshgrid(fy, fx, indexing="ij"))


def _phase_ramp(n: int, shift: float) -> torch.Tensor:
    """exp(+2 pi i (fy + fx) shift) on the unit rfft2 grid, complex64 (n, n//2+1):
    moves an image by -shift pixels on each axis."""
    f = _fftfreq(n)[:, None] + _fftfreq(n, real=True)[None, :]
    return torch.polar(torch.ones_like(f), (f * _TWO_PI) * shift)


def _zernikes(rho: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Circular Noll Zernikes Z4..Z11 (the aberrations GalSim's OpticalPSF
    takes), stacked (8, ...)."""
    return torch.stack([
        math.sqrt(3.0) * (2 * rho**2 - 1),
        math.sqrt(6.0) * rho**2 * torch.sin(2 * theta),
        math.sqrt(6.0) * rho**2 * torch.cos(2 * theta),
        math.sqrt(8.0) * (3 * rho**3 - 2 * rho) * torch.sin(theta),
        math.sqrt(8.0) * (3 * rho**3 - 2 * rho) * torch.cos(theta),
        math.sqrt(8.0) * rho**3 * torch.sin(3 * theta),
        math.sqrt(8.0) * rho**3 * torch.cos(3 * theta),
        math.sqrt(5.0) * (6 * rho**4 - 6 * rho**2 + 1),
    ])


ZERNIKE_KEYS = ("defocus", "astig1", "astig2", "coma1", "coma2", "trefoil1", "trefoil2", "spher")


@functools.lru_cache(maxsize=4)
def _grids(cfg: SimulationConfig, device: torch.device) -> dict:
    """Every grid the renderers share, on ``device``."""
    n, pad = cfg.pupil_n, cfg.pupil_pad
    xs = (torch.arange(pad, dtype=torch.float32) - pad // 2) / (n / 2.0)  # aperture-radius units
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    rho = torch.sqrt(X**2 + Y**2)
    nh, s = cfg.n_hi, cfg.scale_hi
    NUY, NUX = _freq_grid(nh, s)
    half = (nh - 1) / 2.0
    gx = (torch.arange(nh, dtype=torch.float32) - half) * s
    GY, GX = torch.meshgrid(gx, gx, indexing="ij")
    sigma_hst = cfg.hst_fwhm / 2.3548
    grids = dict(
        rho=rho,
        zernikes=_zernikes(rho, torch.atan2(Y, X)),
        NUY=NUY, NUX=NUX,
        mtf_pix=torch.sinc(NUX * s) * torch.sinc(NUY * s),
        mtf_hst=torch.exp(-2 * (math.pi**2) * (sigma_hst**2) * (NUX**2 + NUY**2)),
        # centre the PSF at the stamp's true centre (n-1)/2, half a pixel from
        # the fftshift grid point, as GalSim draws even stamps
        centre=_phase_ramp(nh, 0.5),
        # undo that centring inside the observation's convolution
        decenter=_phase_ramp(nh, (nh - 1) / 2.0),
        GX=GX, GY=GY,
    )
    return {k: v.to(device) for k, v in grids.items()}


# samples per batch of the pupil autocorrelation: ~50 bytes of intermediates
# per pupil pixel, so 2**25 pixels is ~1.7 GB (32 samples at pupil_pad 1024)
_RENDER_PIXELS = 2**25


def _sub_batch(cfg: SimulationConfig) -> int:
    return max(1, _RENDER_PIXELS // cfg.pupil_pad**2)


def _col(x) -> torch.Tensor:
    """(B,) -> (B, 1, 1); scalars pass through."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x[:, None, None] if x.ndim == 1 else x


# ---------------------------------------------------------------------------
# Optical OTF: the pupil's autocorrelation
# ---------------------------------------------------------------------------


def optical_autocorr(params: dict, cfg: SimulationConfig) -> torch.Tensor:
    """Pupil autocorrelations (B, pad, pad), fftshifted to the centre,
    normalised to 1 at zero shift.  Grid spacing: D / pupil_n per sample."""
    g = _grids(cfg, params["obscuration"].device)
    pad = cfg.pupil_pad
    phase = None
    for key, z in zip(ZERNIKE_KEYS, g["zernikes"]):  # the JAX package's order of terms
        term = _col(params[key]) * z
        phase = term if phase is None else phase + term
    aperture = (g["rho"] <= 1.0) & (g["rho"] >= _col(params["obscuration"]))
    pupil = torch.polar(aperture.float(), phase * _TWO_PI)
    amp = torch.fft.fft2(torch.fft.ifftshift(pupil, dim=(-2, -1))).abs() ** 2
    acorr = torch.fft.fftshift(torch.fft.ifft2(amp.to(torch.complex64)), dim=(-2, -1)).real
    return acorr / acorr[:, pad // 2, pad // 2, None, None]


def bilinear_sample(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(img[b], (y[b], x[b]), order=1,
    mode="constant", cval=0)`` for each b: img (B, H, W), y and x (B, ...).

    Floor, four gathers and weights; a neighbour outside the grid counts 0.
    The corners are summed in map_coordinates' order.
    """
    B, H, W = img.shape
    flat = img.reshape(B, H * W)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.to(torch.int64), x0.to(torch.int64)
    out = None
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, -1)
            v = torch.where(valid, flat.gather(1, idx).reshape(y.shape), 0.0)
            term = (wy * wx) * v
            out = term if out is None else out + term
    return out


def sample_optical_otf(acorr: torch.Tensor, nu_x, nu_y, lam_over_diam, cfg: SimulationConfig) -> torch.Tensor:
    """Sample the pupil autocorrelations (B, pad, pad) at the shifts lambda nu
    (bilinear): a frequency nu (cycles/arcsec) is a shift of lam_over_diam * nu
    aperture diameters, that times pupil_n grid samples."""
    pad = cfg.pupil_pad
    lam = _col(lam_over_diam)
    sx = lam * nu_x * cfg.pupil_n
    sy = lam * nu_y * cfg.pupil_n
    return bilinear_sample(acorr, sy + pad // 2, sx + pad // 2)


def _apply(S: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2-vector field (a, b) through the (B, 2, 2) matrices S, written
    out as the JAX package writes it."""
    s = S[..., None, None]
    return s[:, 0, 0] * a + s[:, 0, 1] * b, s[:, 1, 0] * a + s[:, 1, 1] * b


# ---------------------------------------------------------------------------
# PSF and galaxy rendering
# ---------------------------------------------------------------------------


def render_psf(params: dict, cfg: SimulationConfig, g1_err=0.0, g2_err=0.0, fwhm=None) -> torch.Tensor:
    """Draw (B, n_hi, n_hi) PSF images with unit flux, centred.

    ``g1_err``/``g2_err`` (scalars or (B,)) shear the overall PSF, the
    systematic-error sets; ``fwhm`` ((B,)) overrides the atmospheric seeing.
    """
    dev = params["atmos_fwhm"].device
    g = _grids(cfg, dev)
    B = params["atmos_fwhm"].shape[0]
    NUY, NUX = g["NUY"], g["NUX"]

    # a profile sheared by S has OTF(S^T nu); S is symmetric
    g1_err, g2_err = (e.to(device=dev, dtype=torch.float32).expand(B) if isinstance(e, torch.Tensor)
                      else torch.full((B,), float(e), device=dev) for e in (g1_err, g2_err))
    nux, nuy = _apply(reduced_shear_matrix(g1_err, g2_err).mT, NUX, NUY)

    g_atm = distortion_to_g(params["atmos_e"])
    b = params["atmos_beta"]
    anux, anuy = _apply(reduced_shear_matrix(g_atm * torch.cos(2 * b), g_atm * torch.sin(2 * b)).mT, nux, nuy)
    fwhm_val = params["atmos_fwhm"] if fwhm is None else fwhm
    mtf_atm = kolmogorov_mtf(anux, anuy, _col(fwhm_val))

    step = _sub_batch(cfg)
    otf_opt = torch.cat([
        sample_optical_otf(optical_autocorr({k: v[i:i + step] for k, v in params.items()}, cfg),
                           nux[i:i + step], nuy[i:i + step], params["lam_over_diam"][i:i + step], cfg)
        for i in range(0, B, step)])

    otf = mtf_atm * otf_opt * g["mtf_pix"]
    n = cfg.n_hi
    psf = torch.fft.fftshift(torch.fft.irfft2(otf * g["centre"], s=(n, n)), dim=(-2, -1))
    psf = psf.clamp_min(0.0)
    return psf / psf.sum(dim=(-2, -1), keepdim=True)


def _sersic_b(n):
    return 2.0 * n - 1.0 / 3.0 + 4.0 / (405.0 * n)


def render_galaxy(params: dict, cfg: SimulationConfig) -> torch.Tensor:
    """Draw (B, n_hi, n_hi) galaxy images, unit flux, lensing applied:
    intrinsic profile -> rotate(theta) -> shear(g, beta) -> magnify(mu) ->
    sub-pixel offset -> HST-like PSF (the reference's order)."""
    g = _grids(cfg, params["dx"].device)
    s = cfg.scale_hi
    # offsets are in units of the high-res drawn pixel
    X = g["GX"] - _col(params["dx"]) * s
    Y = g["GY"] - _col(params["dy"]) * s

    # lensing: image -> source coordinates through the inverse shear and magnification
    root_mu = torch.sqrt(_col(params["gal_mu"]))
    gg, beta = params["gal_g"], params["gal_beta"]
    Sinv = reduced_shear_matrix(-(gg * torch.cos(2 * beta)), -(gg * torch.sin(2 * beta)))
    sx, sy = _apply(Sinv, X, Y)
    xs_, ys_ = sx / root_mu, sy / root_mu

    # intrinsic frame: rotate by theta + the intrinsic position angle
    ang = _col(params["theta"] + params["phi_int"])
    ca, sa = torch.cos(ang), torch.sin(ang)
    u = ca * xs_ + sa * ys_
    v = -sa * xs_ + ca * ys_
    q = _col(params["q_int"])
    r = torch.sqrt((u * torch.sqrt(q)) ** 2 + (v / torch.sqrt(q)) ** 2)

    ns, re = _col(params["sersic_n"]), _col(params["half_light_radius"])
    gal = torch.exp(-_sersic_b(ns) * ((r / re + 1e-12) ** (1.0 / ns) - 1.0))
    gal = gal / gal.sum(dim=(-2, -1), keepdim=True)

    if cfg.knot_frac_max > 0.0:  # clumpy core, in the intrinsic frame
        knots = torch.zeros_like(gal)
        inv_two_s2 = 1.0 / (2.0 * cfg.knot_sigma**2)
        for k in range(cfg.n_knots):
            du = u - _col(params["knot_u"][:, k])
            dv = v - _col(params["knot_v"][:, k])
            knots = knots + _col(params["knot_f"][:, k]) * torch.exp(-(du * du + dv * dv) * inv_two_s2)
        knots = knots / torch.clamp_min(knots.sum(dim=(-2, -1), keepdim=True), 1e-12)
        frac = _col(params["knot_frac"])
        gal = (1.0 - frac) * gal + frac * knots

    if cfg.env_frac_max > 0.0:  # diffuse exponential envelope
        qe = 1.0 - (1.0 - q) * cfg.env_ellip_ratio
        re_env = cfg.env_size_ratio * re
        r_env = torch.sqrt((u * torch.sqrt(qe)) ** 2 + (v / torch.sqrt(qe)) ** 2)
        env = torch.exp(-_sersic_b(1.0) * (r_env / re_env + 1e-12 - 1.0))
        frac = _col(params["env_frac"])
        gal = (1.0 - frac) * gal + frac * env / env.sum(dim=(-2, -1), keepdim=True)

    n = cfg.n_hi
    gal = torch.fft.irfft2(torch.fft.rfft2(gal) * g["mtf_hst"], s=(n, n))
    gal = gal.clamp_min(0.0)
    return gal / gal.sum(dim=(-2, -1), keepdim=True)


# ---------------------------------------------------------------------------
# Draws (distributions of generate_data.py:204-235)
# ---------------------------------------------------------------------------

_FWHM_X = np.array([0.45, 0.55, 0.65, 0.75, 0.85, 0.95])
_FWHM_F = np.array([0.0, 20.0, 17.0, 13.0, 9.0, 0.0])


@functools.lru_cache(maxsize=None)
def _fwhm_inverse_cdf(npoints: int = 512):
    """Inverse CDF table of the empirical seeing distribution (linear
    interpolation of the reference's spline table)."""
    xs = np.linspace(_FWHM_X[0], _FWHM_X[-1], npoints)
    pdf = np.interp(xs, _FWHM_X, _FWHM_F)
    cdf = np.cumsum(pdf)
    cdf = cdf / cdf[-1]
    return xs.astype(np.float32), cdf.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _fwhm_table(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_fwhm_inverse_cdf` on ``device``, copied there once: a copy from
    the host in every draw would make the host wait for the device."""
    return tuple(torch.from_numpy(a).to(device) for a in _fwhm_inverse_cdf())


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear through (xp, fp), xp increasing, held
    at fp[0] / fp[-1] outside [xp[0], xp[-1]]; where xp repeats, the right value."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    f = torch.where(dx > 0, f0 + (x - x0) / torch.where(dx > 0, dx, 1.0) * (f1 - f0), f1)
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1], f))


def sample_params(gen: torch.Generator, n: int, cfg: SimulationConfig) -> dict:
    """Draw every per-sample simulation parameter for a batch of ``n``, on
    ``gen``'s device, in a fixed order."""
    dev = gen.device

    def u(lo, hi, shape=(n,)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def normal(sd):
        return sd * torch.randn((n,), generator=gen, device=dev)

    xs, cdf = _fwhm_table(dev)
    fwhm = interp(u(0.0, 1.0), cdf, xs)
    a, b_ = 0.01, 0.05  # p(|g|) ∝ |g| on [a, b]
    gal_g = torch.sqrt(u(0.0, 1.0) * (b_**2 - a**2) + a**2)
    p, lo, hi = cfg.snr_power, cfg.snr_min, cfg.snr_max  # p(snr) ∝ snr^-p on [lo, hi]
    snr = (u(0.0, 1.0) * (hi ** (1 - p) - lo ** (1 - p)) + lo ** (1 - p)) ** (1.0 / (1 - p))
    params = dict(
        atmos_fwhm=fwhm,
        gal_g=gal_g,
        snr=snr,
        atmos_e=u(0.01, 0.03),
        atmos_beta=u(0.0, 2 * np.pi),
        defocus=normal(0.36),
        astig1=normal(0.07),
        astig2=normal(0.07),
        coma1=normal(0.07),
        coma2=normal(0.07),
        spher=normal(0.07),
        trefoil1=normal(0.07),
        trefoil2=normal(0.07),
        obscuration=u(0.1, 0.5),
        lam_over_diam=u(0.017, 0.024),
        gal_beta=u(0.0, 2 * np.pi),
        gal_mu=u(1.0, 1.1),
        theta=u(0.0, 2 * np.pi),
        dx=u(-1.0, 1.0),
        dy=u(-1.0, 1.0),
        sersic_n=u(cfg.sersic_n_min, cfg.sersic_n_max),
        half_light_radius=torch.exp(u(math.log(cfg.hlr_min), math.log(cfg.hlr_max))),
        q_int=u(cfg.q_int_min, 1.0),
        env_frac=u(cfg.env_frac_min, cfg.env_frac_max),
        phi_int=u(0.0, 2 * np.pi),
    )
    params.update(_sample_knot_params(gen, params["half_light_radius"], cfg))
    return params


def _sample_knot_params(gen: torch.Generator, half_light_radius: torch.Tensor, cfg: SimulationConfig) -> dict:
    """Knot intrinsics: positions uniform in a disk of knot_r_scale x the
    galaxy's own half-light radius, near-equal normalised fluxes, total knot
    flux fraction uniform on [knot_frac_min, knot_frac_max]."""
    n, K, dev = half_light_radius.shape[0], cfg.n_knots, gen.device
    rad = cfg.knot_r_scale * half_light_radius[:, None] * torch.sqrt(torch.rand((n, K), generator=gen, device=dev))
    ang = 2 * np.pi * torch.rand((n, K), generator=gen, device=dev)
    f = 0.5 + torch.rand((n, K), generator=gen, device=dev)
    frac = cfg.knot_frac_min + (cfg.knot_frac_max - cfg.knot_frac_min) * torch.rand((n,), generator=gen, device=dev)
    return dict(knot_u=rad * torch.cos(ang), knot_v=rad * torch.sin(ang), knot_f=f / f.sum(dim=1, keepdim=True),
                knot_frac=frac)


def draw_noise(gen: torch.Generator, n: int, cfg: SimulationConfig) -> torch.Tensor:
    """The CCD noise of ``n`` observations, (n, fov, fov) in ADU."""
    shape = (n, cfg.fov_pixels, cfg.fov_pixels)
    return noise_sigma(cfg.pixel_scale) * torch.randn(shape, generator=gen, device=gen.device)


def draw_denoise_snr(gen: torch.Generator, n: int) -> torch.Tensor:
    """The denoising task's SNRs, p(snr) ∝ snr^-0.44 on [18, 320] (the
    reference's denoise generator)."""
    p, lo, hi = 0.44, 18.0, 320.0
    t = torch.rand((n,), generator=gen, device=gen.device)
    return (t * (hi ** (1 - p) - lo ** (1 - p)) + lo ** (1 - p)) ** (1.0 / (1 - p))


def draw_signs(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 3) signs +-1 of the PSF errors: g1, g2, FWHM."""
    return torch.where(torch.rand((n, 3), generator=gen, device=gen.device) > 0.5, 1.0, -1.0)


def chunk_generators(seed: int, device) -> tuple[torch.Generator, torch.Generator, torch.Generator]:
    """The three generators of one chunk seed, on ``device``: parameters,
    noise and PSF-error signs, seeded from ``numpy.random.SeedSequence(seed)``'s
    children."""
    children = np.random.SeedSequence(seed).spawn(3)
    return tuple(torch.Generator(device=device).manual_seed(int(c.generate_state(1, np.uint64)[0]))
                 for c in children)


# ---------------------------------------------------------------------------
# Observation synthesis
# ---------------------------------------------------------------------------


def observe(gt_hi: torch.Tensor, psf_hi: torch.Tensor, noise: torch.Tensor, cfg: SimulationConfig) -> torch.Tensor:
    """FFT-convolve at high resolution, downsample, add noise
    (reference generate_data.py:246-257): the observed stamps at fov
    resolution.  The PSF's centring phase is divided out, so obs and gt share
    their sub-pixel registration."""
    n = gt_hi.shape[-1]
    conv = torch.fft.irfft2(torch.fft.rfft2(psf_hi) * _grids(cfg, gt_hi.device)["decenter"] * torch.fft.rfft2(gt_hi),
                            s=(n, n))
    conv = average_downsample(conv, cfg.upsample).clamp_min(0.0)
    return conv + noise


def _shear(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    g, b = params["gal_g"], params["gal_beta"]
    return g * torch.cos(2 * b), g * torch.sin(2 * b)


def render_batch(params: dict, noise: torch.Tensor, cfg: SimulationConfig) -> dict:
    """Render a batch from its draws: obs/psf/gt (n, fov, fov) float32,
    per-sample alpha, snr and the true shear (gal_g1, gal_g2)."""
    sigma = noise_sigma(cfg.pixel_scale)
    psf_hi = render_psf(params, cfg)
    gal_hi = render_galaxy(params, cfg)
    gal_down = average_downsample(gal_hi, cfg.upsample)
    alpha = params["snr"] * sigma / torch.sqrt((gal_down**2).sum(dim=(-2, -1)))
    gt_hi = alpha[:, None, None] * gal_hi
    obs = observe(gt_hi, psf_hi, noise, cfg)
    g1, g2 = _shear(params)
    return dict(obs=obs, psf=average_downsample(psf_hi, cfg.upsample), gt=average_downsample(gt_hi, cfg.upsample),
                alpha=alpha, snr=params["snr"], gal_g1=g1, gal_g2=g2)


def render_batch_denoise(params: dict, snr: torch.Tensor, noise: torch.Tensor, cfg: SimulationConfig) -> dict:
    """Render a denoising-task batch from its draws (reference
    generate_data.py:337-452): no PSF, obs = gt + noise with gt the galaxy at
    fov resolution scaled to ``snr``; ``psf`` is all zeros, ``params["snr"]``
    unused."""
    sigma = noise_sigma(cfg.pixel_scale)
    gal_down = average_downsample(render_galaxy(params, cfg), cfg.upsample)
    alpha = snr * sigma / torch.sqrt((gal_down**2).sum(dim=(-2, -1)))
    gt = alpha[:, None, None] * gal_down
    obs = gt + noise
    g1, g2 = _shear(params)
    return dict(obs=obs, psf=torch.zeros_like(obs), gt=gt, alpha=alpha, snr=snr, gal_g1=g1, gal_g2=g2)


def render_perturbed_psfs(params: dict, signs: torch.Tensor, cfg: SimulationConfig, shear_err: float = 0.0,
                          fwhm_err: float = 0.0) -> torch.Tensor:
    """Each sample's PSF (n, fov, fov) with a systematic error: +-shear_err on
    (g1, g2) and +-fwhm_err on the seeing, signs from ``signs`` (n, 3); a
    seeing pushed below 0 takes the other sign."""
    fwhm = params["atmos_fwhm"] + signs[:, 2] * fwhm_err
    fwhm = torch.where(fwhm < 0, fwhm + 2 * fwhm_err, fwhm)
    psf_hi = render_psf(params, cfg, g1_err=signs[:, 0] * shear_err, g2_err=signs[:, 1] * shear_err, fwhm=fwhm)
    return average_downsample(psf_hi, cfg.upsample)


def simulate_batch(seed: int, n: int, cfg: SimulationConfig = SimulationConfig(), device="cuda") -> dict:
    """Simulate ``n`` samples from chunk seed ``seed`` on ``device``
    (see :func:`render_batch` for the fields)."""
    pgen, ngen, _ = chunk_generators(seed, device)
    return render_batch(sample_params(pgen, n, cfg), draw_noise(ngen, n, cfg), cfg)


def simulate_batch_at_snr(seed: int, n: int, fixed_snr: float, cfg: SimulationConfig = SimulationConfig(),
                          device="cuda") -> dict:
    """The scenes and noise of :func:`simulate_batch` for this seed, the flux
    scaled to a fixed SNR (the reference's obs_{snr} test variants)."""
    pgen, ngen, _ = chunk_generators(seed, device)
    params = sample_params(pgen, n, cfg)
    params["snr"] = torch.full_like(params["snr"], float(fixed_snr))
    return render_batch(params, draw_noise(ngen, n, cfg), cfg)


def simulate_perturbed_psfs(seed: int, n: int, cfg: SimulationConfig = SimulationConfig(), shear_err: float = 0.0,
                            fwhm_err: float = 0.0, device="cuda") -> torch.Tensor:
    """The PSFs of :func:`simulate_batch`'s scenes for this seed with
    systematic errors (reference generate_data.py:291-315); the signs are one
    draw per seed, shared by every error level."""
    pgen, _, sgen = chunk_generators(seed, device)
    return render_perturbed_psfs(sample_params(pgen, n, cfg), draw_signs(sgen, n), cfg, shear_err, fwhm_err)


def simulate_batch_denoise(seed: int, n: int, cfg: SimulationConfig = SimulationConfig(), device="cuda") -> dict:
    """A denoising-task batch from chunk seed ``seed`` on ``device`` (see
    :func:`render_batch_denoise`): the scenes of :func:`simulate_batch`'s
    parameter draw, the SNR drawn after them from the same generator."""
    pgen, ngen, _ = chunk_generators(seed, device)
    params = sample_params(pgen, n, cfg)
    return render_batch_denoise(params, draw_denoise_snr(pgen, n), draw_noise(ngen, n, cfg), cfg)


def to_unit_scale(batch: dict) -> dict:
    """A denoising-task batch divided by its per-sample flux scale alpha: obs =
    gal + noise / alpha on the scale of the ADMM loop variable."""
    a = batch["alpha"][:, None, None]
    return {**batch, "obs": batch["obs"] / a, "gt": batch["gt"] / a}


def simulate_batch_denoise_unit(seed: int, n: int, cfg: SimulationConfig = SimulationConfig(),
                                device="cuda") -> dict:
    """:func:`simulate_batch_denoise` at unit scale (:func:`to_unit_scale`): a
    denoiser trained on it sees inputs at the scale of ADMMNet's z-update
    input x + u1, unlike the reference's raw-ADU denoise training."""
    return to_unit_scale(simulate_batch_denoise(seed, n, cfg, device))
