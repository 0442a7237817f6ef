"""Port parity: galaxy_deconv_tpu_torch.metrics.shear against the JAX FPFS
estimator, both deconv_psf paths, at the tolerance tests/test_metrics.py holds
the numpy twin to: rtol 1e-4, atol 1e-5 (moments relative to their scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.metrics import shear as jshear
from galaxy_deconv_tpu_torch.metrics import shear

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(29)


def galaxies(rng, B=6, hw=48):
    """Sheared elliptical Gaussians with noise, and Gaussian PSFs, centred at (H//2, W//2)."""
    yy, xx = np.mgrid[:hw, :hw] - hw // 2
    gal, psf = [], []
    for _ in range(B):
        a, b, th = rng.uniform(2, 5), rng.uniform(1.5, 3), rng.uniform(0, np.pi)
        xr = xx * np.cos(th) + yy * np.sin(th)
        yr = -xx * np.sin(th) + yy * np.cos(th)
        gal.append(np.exp(-0.5 * ((xr / a) ** 2 + (yr / b) ** 2)) * 100 + rng.standard_normal((hw, hw)))
        s = rng.uniform(1.0, 2.0)
        p = np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf.append(p / p.sum())
    return np.asarray(gal, np.float32), np.asarray(psf, np.float32)


def test_basis_equals_jax():
    for a, b in zip(shear._basis_np((48, 48), 0.6, 0.2), jshear._basis_np((48, 48), 0.6, 0.2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(shear.delta_psf(48, 48), jshear.delta_psf(48, 48))


@pytest.mark.parametrize("deconv_psf", [False, True])
def test_fpfs_moments(rng, deconv_psf):
    gal, psf = galaxies(rng)
    got = shear.fpfs_moments(torch.from_numpy(gal), torch.from_numpy(psf), deconv_psf=deconv_psf)
    want = jshear.fpfs_moments(jnp.asarray(gal), jnp.asarray(psf), deconv_psf=deconv_psf)
    scale = float(np.abs(np.asarray(want["M00"])).max())
    for k in ("M00", "M22c", "M22s", "M40"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("deconv_psf", [False, True])
def test_estimate_shear(rng, deconv_psf):
    gal, psf = galaxies(rng)
    got = shear.estimate_shear(torch.from_numpy(gal), torch.from_numpy(psf), deconv_psf=deconv_psf)
    want = jshear.estimate_shear(jnp.asarray(gal), jnp.asarray(psf), deconv_psf=deconv_psf)
    assert got.shape == (6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_klim_cut_binds(rng):
    # A wide shapelet window (sigma_arcsec 2, so sigma_f < 1 grid pixel) over a
    # near-flat PSF spectrum makes the fpfs klim cut bind below H//2 - 1.
    gal, _ = galaxies(rng, B=2)
    yy, xx = np.mgrid[:48, :48] - 24
    p = np.exp(-0.5 * (xx**2 + yy**2) / 0.5**2).astype(np.float32)
    psf = np.stack([p / p.sum()] * 2)
    P = np.abs(np.fft.rfft2(psf))
    ppow = (P**2 / P.max(axis=(-2, -1), keepdims=True) ** 2).astype(np.float32)
    sigma_f = 48 * 0.2 / (2 * np.pi * 2.0)
    got = shear._klim(torch.from_numpy(ppow), sigma_f, 48).numpy()
    np.testing.assert_array_equal(got, np.asarray(jshear._klim(jnp.asarray(ppow), sigma_f, 48)))
    assert (got < 48 // 2 - 1).all()
    np.testing.assert_allclose(
        shear.estimate_shear(torch.from_numpy(gal), torch.from_numpy(psf), sigma_arcsec=2.0, deconv_psf=True).numpy(),
        np.asarray(jshear.estimate_shear(jnp.asarray(gal), jnp.asarray(psf), sigma_arcsec=2.0, deconv_psf=True)),
        rtol=RTOL, atol=ATOL)
