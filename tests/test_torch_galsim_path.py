"""Port parity: galaxy_deconv_tpu_torch.data.generate_galsim and the fpfs/ngmix
reference estimators against the JAX package's.

galsim, fpfs and ngmix are optional packages, absent here: the observation
step, the downsampling and the packed-layout writer are held to
``galaxy_deconv_tpu/data/generate_galsim.py`` on the same numpy inputs; the
gated imports are held to raise in both packages with the package blocked;
the cases that need the packages compare the two where they exist.

Tolerances: ``_down`` at 1e-7 (float64 means of the same numbers); ``observe``
at 1e-6 of each stamp's peak (the JAX package's numpy core computes in the
input's float32 under numpy 2, the port in float64); the writer's files byte
for byte; the shear rows of ``cli test`` at |dg| <= 1e-5 (1 + |g|), as
tests/test_torch_eval.py holds the harness.
"""

import importlib.util
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu import cli as jcli
from galaxy_deconv_tpu.data import GalaxyDataset as JGalaxyDataset
from galaxy_deconv_tpu.data import generate_galsim as J
from galaxy_deconv_tpu.ops.resize import average_downsample as javerage_downsample
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import GalaxyDataset
from galaxy_deconv_tpu_torch.data import generate_galsim as T
from galaxy_deconv_tpu_torch.data.simulate import noise_sigma

OBSERVE_REL = 1e-6
SHEAR_TOL = 1e-5  # |g_port - g_jax| <= SHEAR_TOL * (1 + |g_jax|)


def peak_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def galaxy_hi(n: int = 192, seed: int = 0, sigma: float = 12.0):
    """A sheared Gaussian galaxy and a Gaussian PSF at the high resolution,
    float32, the PSF summing to 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2 + rng.uniform(-2, 2, 2)[:, None, None]
    e1, e2 = rng.uniform(-0.3, 0.3, 2)
    gal = np.exp(-((1 - e1) * xx**2 - 2 * e2 * xx * yy + (1 + e1) * yy**2) / (2 * sigma**2))
    psf = np.exp(-(xx**2 + yy**2) / (2 * (sigma / 3) ** 2))
    return gal.astype(np.float32), (psf / psf.sum()).astype(np.float32)


# --- _down ------------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [2, 4])
def test_down_matches_jax(rate):
    x = np.random.default_rng(rate).standard_normal((192, 192))
    got = T._down(torch.from_numpy(x), rate).numpy()
    assert got.shape == (192 // rate, 192 // rate)
    np.testing.assert_allclose(got, J._down(x, rate), rtol=0, atol=1e-7)
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(T._down(torch.from_numpy(x32), rate).numpy(),
                               np.asarray(javerage_downsample(jnp.asarray(x32), rate)), rtol=0, atol=1e-6)


# --- observe ----------------------------------------------------------------------------


@pytest.mark.parametrize("snr,upsample,seed", [(20.0, 4, 0), (150.0, 4, 1), (50.0, 2, 2)])
def test_observe_matches_observe_numpy(snr, upsample, seed):
    gal, psf = galaxy_hi(48 * upsample, seed)
    sigma = noise_sigma()
    want = J.observe_numpy(gal, psf, sigma, snr, np.random.default_rng(seed + 7), upsample)
    got = T.observe(gal, psf, sigma, snr, np.random.default_rng(seed + 7), upsample, device="cpu")
    again = T.observe(torch.from_numpy(gal), torch.from_numpy(psf), sigma, snr, np.random.default_rng(seed + 7),
                      upsample, device="cpu")
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32 and g.shape == w.shape == (48, 48)
        assert peak_rel(g, w) <= OBSERVE_REL, peak_rel(g, w)
        assert torch.equal(g, a)
    # ||down(gt)||_2 = snr * sigma (reference generate_data.py:241-244)
    assert np.sqrt((got[1].double() ** 2).sum().item()) == pytest.approx(snr * sigma, rel=1e-6)


def test_observe_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gal, psf = galaxy_hi()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.observe(gal, psf, 1.0, 20.0, np.random.default_rng(0))


# --- the packed writer ------------------------------------------------------------------


def observed_stores(n_train=4, n_test=3, snrs=(20, 100), errs=(0.01,)):
    """Stores, variants, perturbed PSFs and meta of galaxy-like stamps made by
    the JAX package's numpy observation step, as generate_cosmos_dataset
    gathers them."""
    sigma = noise_sigma()
    stores = {"train": {k: [] for k in ("obs", "psf", "gt")}, "test": {k: [] for k in ("obs", "psf", "gt")}}
    variants = {f"obs_{s}": [] for s in snrs} | {f"gt_{s}": [] for s in snrs}
    perturbed = {f"psf_shear_err_{e}": [] for e in errs} | {f"psf_fwhm_err_{e}": [] for e in errs}
    for k in range(n_train + n_test):
        gal, psf = galaxy_hi(192, 100 + k, sigma=8.0 + k)
        rng = np.random.default_rng(31415 + k)
        obs, gt = J.observe_numpy(gal, psf, sigma, 40.0 + 10 * k, rng)
        split = "train" if k < n_train else "test"
        stores[split]["obs"].append(obs)
        stores[split]["psf"].append(J._down(psf, 4))
        stores[split]["gt"].append(gt)
        if k >= n_train:
            for s in snrs:
                o, g = J.observe_numpy(gal, psf, sigma, s, rng)
                variants[f"obs_{s}"].append(o)
                variants[f"gt_{s}"].append(g)
            for name in perturbed:
                perturbed[name].append(J._down(np.roll(psf, 1 + k % 2, axis=k % 2), 4))
    meta = dict(n_train=n_train, n_test=n_test, fov_pixels=48, pixel_scale=0.2, upsample=4, seed=31415,
                snrs=list(snrs), shear_errs=list(errs), fwhm_errs=list(errs), generator="galsim/COSMOS")
    return stores, variants, perturbed, meta


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same stores written by both packages' writers."""
    args = observed_stores()
    root = tmp_path_factory.mktemp("galsim")
    return J.write_packed_dataset(root / "jax", *args), T.write_packed_dataset(root / "port", *args)


def test_writer_files_match_jax_byte_for_byte(trees):
    jroot, troot = trees
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*.npy"))
    assert jfiles == sorted(p.relative_to(troot) for p in troot.rglob("*.npy"))
    assert len(jfiles) == 2 * 7 + 4 + 2
    for rel in jfiles:
        assert (troot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    info = json.loads((troot / "info.json").read_text())
    assert info == json.loads((jroot / "info.json").read_text())
    assert info["generator"] == "galsim/COSMOS"


@pytest.mark.parametrize("split,kw", [
    ("train", {}), ("test", {}), ("test", {"obs_variant": "obs_100"}), ("test", {"obs_variant": "obs_20"}),
    ("test", {"psf_variant": "psf_shear_err_0.01"}), ("test", {"psf_variant": "psf_fwhm_err_0.01"})])
def test_both_readers_give_equal_batches(trees, split, kw):
    jroot, troot = trees
    jds, tds = JGalaxyDataset(jroot, split, **kw), GalaxyDataset(troot, split, **kw)
    assert len(jds) == len(tds) == (4 if split == "train" else 3)
    idx = np.arange(len(tds))
    want, got = jds.batch(idx), tds.batch(idx)
    for k in ("obs", "psf", "gt", "alpha"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["alpha"], got["obs"].mean(axis=(1, 2)), rtol=1e-6)


def test_cli_test_of_both_packages_on_the_tree(trees, tmp_path):
    jroot, troot = trees
    methods = ["No_Deconv", "FPFS"]
    common = ["test", "--test", "shear", "--n_gal", "3", "--eval_batch_size", "2", "--snrs", "20", "100",
              "--methods", *methods]
    jcli.main([*common, "--data_path", str(jroot), "--result_path", str(tmp_path / "jax"), "--n_devices", "1"])
    got = cli.main([*common, "--data_path", str(troot), "--result_path", str(tmp_path / "port"), "--device", "cpu"])
    for method in methods:
        want = json.loads((tmp_path / "jax" / method / "results.json").read_text())
        for snr in ("20", "100"):
            keys = ("rec_shear", "gt_shear") if method == "No_Deconv" else ("rec_shear",)
            for key in keys:
                g, w = np.asarray(got[method][snr][key]), np.asarray(want[snr][key])
                assert g.shape == w.shape == (3, 3) and np.isfinite(g).all()
                err = (np.abs(g - w) / (1 + np.abs(w))).max()
                assert err <= SHEAR_TOL, (method, snr, key, err)


# --- the gated imports ------------------------------------------------------------------


def test_galsim_gate_raises_in_both_packages(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "galsim", None)  # an import of galsim raises, installed or not
    with pytest.raises(ImportError, match="galsim is not installed") as port_err:
        T._require_galsim()
    assert "galaxy_deconv_tpu_torch.data.simulate" in str(port_err.value)
    with pytest.raises(ImportError, match="galsim is not installed"):
        J._require_galsim()
    with pytest.raises(ImportError, match="galsim is not installed"):
        T.generate_cosmos_dataset(tmp_path / "ds", str(tmp_path / "no_catalog"), device="cpu")
    assert not (tmp_path / "ds").exists()


@pytest.mark.parametrize("package,name", [("fpfs", "estimate_shear_fpfs_reference"),
                                          ("ngmix", "estimate_shear_ngmix_reference")])
def test_reference_estimators_exported_and_gated(monkeypatch, package, name):
    import galaxy_deconv_tpu.metrics as jm
    import galaxy_deconv_tpu_torch.metrics as tm

    assert name in tm.__all__ and name in jm.__all__
    monkeypatch.setitem(sys.modules, package, None)
    obs, psf = np.ones((48, 48), np.float32), np.ones((48, 48), np.float32) / 48**2
    for fn in (getattr(tm, name), getattr(jm, name)):
        with pytest.raises(ImportError):
            fn(obs, psf)


# --- where the optional packages exist ---------------------------------------------------


def _present(package: str) -> None:
    if importlib.util.find_spec(package) is None:
        pytest.skip(f"{package} not installed")


def test_draw_psf_matches_jax_where_galsim_exists():  # pragma: no cover - runs only where galsim exists
    _present("galsim")
    galsim = T._require_galsim()
    p = dict(atmos_fwhm=0.65, atmos_e=0.02, atmos_beta=0.3, defocus=0.1, astig1=0.0, astig2=0.0, coma1=0.0,
             coma2=0.0, spher=0.0, trefoil1=0.0, trefoil2=0.0, obscuration=0.3, lam_over_diam=0.02)
    got = T._draw_psf(galsim, p, 48, 0.2, 4)
    assert got.shape == (192, 192) and got.sum() == pytest.approx(1.0, rel=1e-2)
    np.testing.assert_array_equal(got, J._draw_psf(galsim, p, 48, 0.2, 4))


@pytest.mark.parametrize("package,name", [("fpfs", "estimate_shear_fpfs_reference"),
                                          ("ngmix", "estimate_shear_ngmix_reference")])
def test_reference_estimators_match_jax_where_installed(package, name):  # pragma: no cover
    _present(package)
    import galaxy_deconv_tpu.metrics as jm
    import galaxy_deconv_tpu_torch.metrics as tm

    stores = observed_stores(n_train=1, n_test=0, snrs=(), errs=())[0]["train"]
    obs, psf = stores["obs"][0], stores["psf"][0]
    np.testing.assert_allclose(np.asarray(getattr(tm, name)(obs, psf), np.float64),
                               np.asarray(getattr(jm, name)(obs, psf), np.float64), rtol=1e-12)
