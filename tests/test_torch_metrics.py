"""Port parity: galaxy_deconv_tpu_torch.metrics.adaptive_moments and
metrics.fpfs_numpy against the JAX package's on the same numpy stamps (8
sheared elliptical Gaussians of ``chip_smoke.galaxy_stamps`` with noise,
48 x 48)."""

import importlib
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.metrics import fpfs_numpy as jfpfs
from galaxy_deconv_tpu_torch.metrics import fpfs_numpy as tfpfs
from test_torch_online import one_thread  # noqa: F401  (autouse: one torch thread here too)

# the modules, which the packages' functions of the same name shadow
jam = importlib.import_module("galaxy_deconv_tpu.metrics.adaptive_moments")
tam = importlib.import_module("galaxy_deconv_tpu_torch.metrics.adaptive_moments")

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def stamps():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    s = cs.galaxy_stamps(8, seed=21)
    return s["obs"], s["gt"], s["psf"]


@pytest.mark.parametrize("which", ["obs", "gt"])
def test_adaptive_moments_match_jax(stamps, which):
    # 30 fixed-point rounds in float32: every field within 1e-5 of its largest
    # entry (readings up to 2.9e-6, e1), the residual |2P - W|, a difference of
    # near-equal moments at the fixed point, within 1e-5 of the largest size T;
    # the shears at 1e-5 absolute
    img = stamps[0] if which == "obs" else stamps[1]
    got, want = tam.adaptive_moments(torch.from_numpy(img)), jam.adaptive_moments(jnp.asarray(img))
    assert got.keys() == want.keys()
    T = np.abs(np.asarray(want["T"])).max()
    for k in got:
        w = np.asarray(want[k])
        scale = T if k == "resid" else np.abs(w).max()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=k)
    np.testing.assert_allclose(tam.estimate_shear_adaptive(torch.from_numpy(img)).numpy(),
                               np.asarray(jam.estimate_shear_adaptive(jnp.asarray(img))), rtol=0, atol=1e-5)


def test_adaptive_moments_recover_a_gaussian():
    # a centred elliptical Gaussian of covariance [[6, 1.5], [1.5, 3]] (x, y):
    # the fixed point is that covariance
    yy, xx = np.mgrid[:48, :48].astype(np.float64) - 23.5
    cov = np.array([[6.0, 1.5], [1.5, 3.0]])
    inv = np.linalg.inv(cov)
    img = np.exp(-0.5 * (inv[0, 0] * xx**2 + 2 * inv[0, 1] * xx * yy + inv[1, 1] * yy**2)).astype(np.float32)
    m = tam.adaptive_moments(torch.from_numpy(img[None]), n_iter=60)
    T = cov[0, 0] + cov[1, 1]
    np.testing.assert_allclose([float(m["T"][0]), float(m["e1"][0]), float(m["e2"][0])],
                               [T, (cov[0, 0] - cov[1, 1]) / T, 2 * cov[0, 1] / T], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("with_psf", [False, True])
def test_fpfs_numpy_is_jaxs_bit_for_bit(stamps, with_psf):
    # the same numpy float64 code: moments and shears equal exactly
    obs, _, psf = stamps
    for i in range(len(obs)):
        p = psf[i] if with_psf else None
        assert tfpfs.fpfs_moments_numpy(obs[i], p) == jfpfs.fpfs_moments_numpy(obs[i], p)
        assert tfpfs.estimate_shear_numpy(obs[i], p) == jfpfs.estimate_shear_numpy(obs[i], p)
    np.testing.assert_array_equal(tfpfs.delta_psf(48, 40), jfpfs.delta_psf(48, 40))
