"""Port parity: the baseline solvers, build_model, psnr and the evaluation
harness (galaxy_deconv_tpu_torch.eval) against the JAX package.

Tolerances, each stated where it is used: the solvers against the reference's
goldens at 2e-4 of the golden's peak (as tests/test_solvers.py holds Wiener)
and against JAX at 1e-5 of the peak (float32 FFTs in two libraries; the CPU
reads 2e-7 to 3e-6); shears against JAX's harness at |dg| <= 1e-5 (1 + |g|)
(readings 1e-7 to 1.1e-6, the trained flagship included).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import SimulationConfig, generate_dataset
from galaxy_deconv_tpu.eval import harness as J
from galaxy_deconv_tpu.metrics import psnr as jpsnr
from galaxy_deconv_tpu.models import RichardsonLucy as JRichardsonLucy
from galaxy_deconv_tpu.models import Wiener as JWiener
from galaxy_deconv_tpu.ops import fourier as jfourier
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import GalaxyDataset
from galaxy_deconv_tpu_torch.eval import harness as T
from galaxy_deconv_tpu_torch.metrics import estimate_shear, psnr
from galaxy_deconv_tpu_torch.models import (NoDeconv, RichardsonLucy, UnrolledADMMGaussian, Wiener,
                                            build_model)
from galaxy_deconv_tpu_torch.ops import fourier
from galaxy_deconv_tpu_torch.train import create_train_state
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.utils import model_state_dict

GOLDEN_REL = 2e-4
JAX_REL = 1e-5
SHEAR_TOL = 1e-5  # |g_port - g_jax| <= SHEAR_TOL * (1 + |g_jax|)
FLAGSHIP = ("Gaussian_PnP_ADMM_8iters_MultiScale", 7000)
SNRS = (20, 100)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_peak_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"max |port - ref| / max |ref| = {err:.3e} > {rel}"


@pytest.fixture(scope="module")
def stamps(fixtures_dir):
    d = np.load(fixtures_dir / "solver_goldens.npz")
    return {k: d[k] for k in d.files}


# --- ops/fourier.py -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [None, (48, 48), (64, 64)])
def test_psf_to_otf_and_conv_fft_match_jax(rng, shape):
    psf = rng.random((2, 48, 48)).astype(np.float32)
    x = rng.standard_normal((2,) + (shape or (48, 48))).astype(np.float32)
    want = np.asarray(jfourier.psf_to_otf(psf, shape))
    got = fourier.psf_to_otf(t(psf), shape)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(fourier.otf_from_centered_psf(t(psf), shape).numpy(), got.numpy(), rtol=0, atol=0)
    assert_peak_rel(fourier.conv_fft(got, t(x)), jfourier.conv_fft(jnp.asarray(want), x), JAX_REL)


# --- the baseline solvers -------------------------------------------------------------


def one(stamps, key):
    return t(stamps[key][None])


def test_wiener_golden_and_jax(stamps):
    alpha = torch.tensor([float(stamps["alpha"])])
    rec = Wiener()(one(stamps, "obs"), one(stamps, "psf"), alpha)[0]
    assert_peak_rel(rec, stamps["wiener"], GOLDEN_REL)
    args = (stamps["obs"][None], stamps["psf"][None], np.array([stamps["alpha"]], np.float32))
    want = JWiener().apply({}, *args)[0]
    assert_peak_rel(rec, want, JAX_REL)


def test_wiener_delta_psf_closed_form(rng):
    obs = rng.standard_normal((2, 48, 48)).astype(np.float32)
    psf = np.zeros((2, 48, 48), np.float32)
    psf[:, 24, 24] = 1.0
    rec = Wiener()(t(obs), t(psf), torch.tensor([2.0, 5.0]))
    want = obs * (np.array([2.0, 5.0]) / (np.array([2.0, 5.0]) + 350.0))[:, None, None]
    np.testing.assert_allclose(rec.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_iters,key", [(10, "rl10"), (30, "rl30")])
def test_richardson_lucy_golden_and_jax(stamps, n_iters, key):
    rec = RichardsonLucy(n_iters)(one(stamps, "obs"), one(stamps, "psf"))[0]
    assert_peak_rel(rec, stamps[key], GOLDEN_REL)
    want = JRichardsonLucy(n_iters=n_iters).apply({}, stamps["obs"][None], stamps["psf"][None])[0]
    assert_peak_rel(rec, want, JAX_REL)


def test_richardson_lucy_delta_psf_is_identity(rng):
    obs = np.abs(rng.standard_normal((1, 48, 48))).astype(np.float32)
    psf = np.zeros((1, 48, 48), np.float32)
    psf[:, 24, 24] = 1.0
    np.testing.assert_allclose(RichardsonLucy(5)(t(obs), t(psf)).numpy(), obs, rtol=1e-3, atol=1e-4)


def test_richardson_lucy_eps_guards_the_ratio(stamps):
    args = (stamps["obs"][None], stamps["psf"][None])
    got = RichardsonLucy(10, eps=1e-3)(*map(t, args))
    assert_peak_rel(got, JRichardsonLucy(n_iters=10, eps=1e-3).apply({}, *args), JAX_REL)


@pytest.mark.parametrize("n_iters", [10, 30, 100])
def test_richardson_lucy_matches_jax_on_simulated_stamps(root, n_iters):
    """eps = 0 divides by Hx wherever it is at round-off; on these stamps no
    pixel diverges: each galaxy within 1e-5 of its JAX reconstruction's peak
    (CPU readings 8e-7, 1.3e-6 and 3.3e-6)."""
    for snr in SNRS:
        ds = GalaxyDataset(root, "test", obs_variant=f"obs_{snr}")
        obs, psf = np.array(ds.obs, np.float32), np.array(ds.psf, np.float32)
        want = np.asarray(JRichardsonLucy(n_iters=n_iters).apply({}, obs, psf))
        got = RichardsonLucy(n_iters)(t(obs), t(psf)).numpy()
        assert np.isfinite(got).all()
        err = (np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))).max()
        assert err <= JAX_REL, f"snr {snr}: {err:.3e}"


def test_wiener_matches_jax_on_simulated_stamps(root):
    ds = GalaxyDataset(root, "test")
    b = ds.batch(np.arange(len(ds)))
    want = JWiener().apply({}, b["obs"], b["psf"], b["alpha"])
    assert_peak_rel(Wiener()(t(b["obs"]), t(b["psf"]), t(b["alpha"])), want, JAX_REL)


def test_no_deconv_is_the_identity(stamps):
    obs = one(stamps, "obs")
    assert torch.equal(NoDeconv()(obs, obs, torch.ones(1)), obs)


# --- build_model ----------------------------------------------------------------------


@pytest.mark.parametrize("name,cls,n_iters", [
    ("No_Deconv", NoDeconv, None),
    ("FPFS", NoDeconv, None),
    ("Wiener", Wiener, None),
    ("Richard-Lucy(30)", RichardsonLucy, 30),
    ("Richard-Lucy", RichardsonLucy, 30),
    ("Unrolled_ADMM_Gaussian(2)", UnrolledADMMGaussian, 2),
    ("Unrolled_ADMM_Gaussian_Bounded(2)", UnrolledADMMGaussian, 2),
])
def test_build_model_names_and_suffixes(name, cls, n_iters):
    m = build_model(name, **({"features": (8, 8, 8, 8)} if cls is UnrolledADMMGaussian else {}))
    assert isinstance(m, cls)
    if n_iters is not None:
        assert m.n_iters == n_iters
    if name.startswith("Unrolled_ADMM_Gaussian_Bounded"):
        assert m.rho_bounds == (0.1, 10.0)


@pytest.mark.parametrize("name", ["Unrolled_ADMM(8)", "Tikhonet", "Tikhonet_Laplacian", "ShapeNet", "ADMMNet",
                                  "ADMMNet_scaled", "ADMMNet_fixed", "ResUNet"])
def test_build_model_refuses_unported_jax_names(name):
    """Every zoo name of the JAX registry builds, with the JAX module's
    attributes: n_iters from the suffix, Tikhonet's filter, ADMMNet's
    denoiser_scale and poisson_prox (the name is kept from when these were
    refused)."""
    from galaxy_deconv_tpu.models import registry as jregistry

    want, got = jregistry.build_model(name), build_model(name)
    assert type(got).__name__ == {"ResUNet": "ResUNetDenoiser"}.get(type(want).__name__, type(want).__name__)
    for attr in ("n_iters", "filter", "laplacian", "llh", "denoiser_scale", "poisson_prox", "rho1", "rho2"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    if name == "Unrolled_ADMM(8)":
        assert got.n_iters == 8 and got.subnet.dense[2].out_features == 16


def test_build_model_unknown_name_raises_keyerror():
    with pytest.raises(KeyError):
        build_model("NotAModel")


# --- psnr -----------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
def test_psnr_matches_jax(rng, normalize):
    a = rng.standard_normal((3, 48, 48)).astype(np.float32) * 10
    b = a + rng.standard_normal((3, 48, 48)).astype(np.float32)
    np.testing.assert_allclose(psnr(t(a), t(b), normalize).numpy(), np.asarray(jpsnr(a, b, normalize)), rtol=1e-5)


# --- the harness against JAX's, on a tree of the JAX generator ---------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_dataset(tmp_path_factory.mktemp("ds"), n_train=10, n_test=10, cfg=SimulationConfig(pupil_n=64,
                            pupil_pad=128), chunk=10, snrs=SNRS, shear_errs=(0.02,), fwhm_errs=(0.05,),
                            verbose=False)


@pytest.fixture(scope="module")
def flagship():
    """The trained flagship's flax variables and the port's state_dict (the bridge)."""
    from galaxy_deconv_tpu.train.checkpoint import restore_checkpoint, unpack_variables

    trained = pathlib.Path(__file__).resolve().parent.parent / "trained"
    v = jax.tree.map(np.asarray, unpack_variables(restore_checkpoint(trained, *FLAGSHIP)))
    return v, model_state_dict(v["params"], v["batch_stats"])


METHODS = ["No_Deconv", "FPFS", "Wiener", "Richard-Lucy(10)", "Unrolled_ADMM_Gaussian(8)"]


def weights(method, flagship):
    if method.startswith("Unrolled"):
        return {"variables": flagship[0]}, {"state_dict": flagship[1]}
    return {}, {}


def sizes(method):
    """(snrs, n_gal, batch_size): the baselines sweep 10 galaxies at batch 8
    over both SNRs (a ragged tail of 2); the full-width flagship, for CPU
    time, 5 at batch 4 at SNR 100 (a ragged tail of 1)."""
    return ((100,), 5, 4) if method.startswith("Unrolled") else (SNRS, 10, 8)


def assert_shears_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= SHEAR_TOL, f"max |g_port - g_jax| / (1 + |g_jax|) = {err:.3e} > {SHEAR_TOL}"


def assert_same_keys(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys(), k


@pytest.mark.parametrize("method", METHODS)
def test_shear_test_matches_jax(root, tmp_path, flagship, method):
    """A ragged final batch, padded and trimmed."""
    jw, tw = weights(method, flagship)
    snrs, n, bs = sizes(method)
    want = J.run_shear_test(method, root, tmp_path / "jax", snrs=snrs, n_gal=n, batch_size=bs, **jw)
    got = T.run_shear_test(method, root, tmp_path / "port", snrs=snrs, n_gal=n, batch_size=bs, device="cpu", **tw)
    on_disk = json.loads((tmp_path / "port" / method / "results.json").read_text())
    assert on_disk == got
    assert_same_keys(got, want)
    assert got["meta"] == {"data_root": str(root), "n_gal": n}
    for snr in map(str, snrs):
        assert len(got[snr]["rec_shear"]) == n
        assert_shears_close(got[snr]["rec_shear"], want[snr]["rec_shear"])
        if method == "No_Deconv":
            assert_shears_close(got[snr]["gt_shear"], want[snr]["gt_shear"])


@pytest.mark.parametrize("method,kind,err", [
    *((m, k, e) for m in ("FPFS", "Wiener", "Richard-Lucy(10)") for k, e in (("shear", 0.02), ("fwhm", 0.05))),
    ("Unrolled_ADMM_Gaussian(8)", "shear", 0.02),
])
def test_psf_error_test_matches_jax(root, tmp_path, flagship, method, kind, err):
    jw, tw = weights(method, flagship)
    _, n, bs = sizes(method)
    want = J.run_psf_error_test(method, root, tmp_path / "jax", errs=(err,), kind=kind, n_gal=n, batch_size=bs, **jw)
    got = T.run_psf_error_test(method, root, tmp_path / "port", errs=(err,), kind=kind, n_gal=n, batch_size=bs,
                               device="cpu", **tw)
    assert (tmp_path / "port" / method / f"results_psf_{kind}_err.json").exists()
    assert_same_keys(got, want)
    assert_shears_close(got[str(err)]["rec_shear"], want[str(err)]["rec_shear"])


@pytest.mark.parametrize("method", ["No_Deconv", "Wiener", "Richard-Lucy(10)", "Unrolled_ADMM_Gaussian(8)"])
def test_psnr_test_matches_jax(root, tmp_path, flagship, method):
    jw, tw = weights(method, flagship)
    snrs, n, bs = sizes(method)
    want = J.run_psnr_test(method, root, tmp_path / "jax", snrs=snrs, n_gal=n, batch_size=bs, **jw)
    got = T.run_psnr_test(method, root, tmp_path / "port", snrs=snrs, n_gal=n, batch_size=bs, device="cpu", **tw)
    assert_same_keys(got, want)
    for snr in map(str, snrs):
        for k in ("psnr_mean", "psnr_median"):
            assert np.isfinite(got[snr][k])
            np.testing.assert_allclose(got[snr][k], want[snr][k], rtol=1e-5)


def test_time_test_matches_jax_schema(root, tmp_path):
    """Whole batches only: 10 galaxies at batch 8 time 8, at batch 4 time 8."""
    for bs, timed in ((8, 8), (4, 8), (16, 16)):
        J.run_time_test("Wiener", root, tmp_path / "jax", n_gal=10, batch_size=bs, warmup=1, repeats=2)
        elapsed = T.run_time_test("Wiener", root, tmp_path / "port", n_gal=10, batch_size=bs, warmup=1, repeats=2,
                                  device="cpu")
        got, want = (json.loads((tmp_path / d / "Wiener" / "results.json").read_text()) for d in ("port", "jax"))
        assert_same_keys(got, want)
        assert got["time"] == [elapsed, min(timed, 10)]
        assert got["time_spread"][0] <= elapsed <= got["time_spread"][1]


def test_bulk_path_matches_per_batch_oracle(root):
    """One upload per field and on-device slicing give a naive per-batch
    loop over GalaxyDataset.batch's answer bit for bit."""
    ds = GalaxyDataset(root, "test", obs_variant="obs_100")
    apply_fn = T.make_apply_fn("Richard-Lucy(10)", device="cpu")
    bulk = T._rec_shear_bulk(apply_fn, ds, 10, 4, "Richard-Lucy(10)", "cpu")
    oracle = []
    for s in range(0, 12, 4):
        idx = np.arange(s, min(s + 4, 10))
        take = idx.shape[0]
        idx = np.concatenate([idx, np.full(4 - take, idx[-1])])
        b = ds.batch(idx)
        oracle.append(estimate_shear(apply_fn(t(b["obs"]), t(b["psf"]), t(b["alpha"]))).numpy()[:take])
    np.testing.assert_array_equal(bulk, np.concatenate(oracle))


def test_psf_cache_is_reused_across_snr_variants(root):
    cache: dict = {}
    held = []
    for snr in SNRS:
        ds = GalaxyDataset(root, "test", obs_variant=f"obs_{snr}")
        T._rec_shear_bulk(None, ds, 10, 8, "No_Deconv", "cpu", cache=cache, cache_fields=("psf",))
        held.append(cache[("psf", 10, 8)][0])
    assert list(cache) == [("psf", 10, 8)] and held[0] is held[1] and held[0].shape == (16, 48, 48)


def test_merge_write_drops_rows_of_another_dataset(tmp_path):
    path = tmp_path / "m" / "results.json"
    T._merge_write(path, {"20": {"rec_shear": [1], "data_root": "A"}, "meta": {"data_root": "A"}}, data_root="A")
    T._merge_write(path, {"40": {"rec_shear": [2], "data_root": "A"}}, data_root="A")
    assert set(json.loads(path.read_text())) == {"20", "40", "meta"}
    T._merge_write(path, {"60": {"rec_shear": [3], "data_root": "B"}, "meta": {"data_root": "B"}}, data_root="B")
    assert set(json.loads(path.read_text())) == {"60", "meta"}
    assert not path.with_suffix(".json.tmp").exists()


def test_median_ellipticity_error_matches_jax(root, tmp_path):
    res = T.run_shear_test("No_Deconv", root, tmp_path, snrs=(20,), n_gal=10, batch_size=8, device="cpu")
    wie = T.run_shear_test("Wiener", root, tmp_path, snrs=(20,), n_gal=10, batch_size=8, device="cpu")
    assert T.median_ellipticity_error(wie, res, 20) == J.median_ellipticity_error(wie, res, 20)
    assert 0 <= T.median_ellipticity_error(wie, res, 20) <= 1


def test_make_apply_fn_seeds_weights_from_zero():
    a = T.make_apply_fn("Unrolled_ADMM_Gaussian(1)", device="cpu", features=(8, 8, 8, 8))
    b = T.make_apply_fn("Unrolled_ADMM_Gaussian(1)", device="cpu", features=(8, 8, 8, 8))
    x = torch.rand(2, 48, 48) * 10
    p = torch.rand(2, 48, 48)
    assert torch.equal(a(x, p / p.sum(), torch.ones(2)), b(x, p / p.sum(), torch.ones(2)))


def test_make_apply_fn_runs_with_tf32_off_and_restores_flags():
    """The harness's models run in float32 (TF32 off for cuDNN and CUDA
    matmuls) whatever the caller set, and the caller's flags come back."""
    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    apply_fn = T.make_apply_fn("Unrolled_ADMM_Gaussian(1)", device="cpu", features=(8, 8, 8, 8))
    seen = []
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, *_: seen.append(flags()) if isinstance(mod, UnrolledADMMGaussian) else None)
    before = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        apply_fn(torch.rand(2, 48, 48), torch.full((2, 48, 48), 1 / 48**2), torch.ones(2))
        after = flags()
    finally:
        handle.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, False)] and after == (True, True)


# --- cli test -------------------------------------------------------------------------


def test_cli_test_runs_each_sweep(root, tmp_path):
    res = tmp_path / "res"
    base = ["test", "--data_path", str(root), "--result_path", str(res), "--n_gal", "10", "--eval_batch_size", "8",
            "--device", "cpu"]
    cli.main(base + ["--snrs", "20", "--methods", "No_Deconv", "Wiener"])
    cli.main(base + ["--test", "time", "--methods", "Wiener"])
    cli.main(base + ["--test", "psf_shear", "--errs", "0.02", "--methods", "Wiener"])
    cli.main(base + ["--test", "psf_fwhm", "--errs", "0.05", "--methods", "Wiener"])
    got = json.loads((res / "Wiener" / "results.json").read_text())
    assert {"20", "time", "time_spread", "meta"} <= set(got)
    assert json.loads((res / "Wiener" / "results_psf_shear_err.json").read_text()).keys() == {"0.02", "meta"}
    assert json.loads((res / "Wiener" / "results_psf_fwhm_err.json").read_text()).keys() == {"0.05", "meta"}
    assert "gt_shear" in json.loads((res / "No_Deconv" / "results.json").read_text())["20"]


def test_cli_test_default_methods(root, tmp_path):
    cli.main(["test", "--data_path", str(root), "--result_path", str(tmp_path), "--n_gal", "2", "--snrs", "100",
              "--eval_batch_size", "2", "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(cli.DEFAULT_METHODS)


def test_cli_test_loads_a_checkpoint(root, tmp_path, flagship):
    """--checkpoint_name: the port's checkpoint of the trained flagship gives
    JAX's shears; --checkpoint_epoch 0 takes the run's latest epoch."""
    model = UnrolledADMMGaussian()
    state, _ = create_train_state(model, 0)
    model.load_state_dict(flagship[1])
    save_checkpoint(tmp_path / "models", FLAGSHIP[0], FLAGSHIP[1], state)
    method = "Unrolled_ADMM_Gaussian(8)"
    got = cli.main(["test", "--data_path", str(root), "--result_path", str(tmp_path / "res"), "--n_gal", "4",
                    "--eval_batch_size", "4", "--snrs", "100", "--device", "cpu", "--methods", method,
                    "--model_save_path", str(tmp_path / "models"), "--checkpoint_name", FLAGSHIP[0]])[method]
    want = J.run_shear_test(method, root, tmp_path / "jax", snrs=(100,), n_gal=4, batch_size=4,
                            variables=flagship[0])
    assert_shears_close(got["100"]["rec_shear"], want["100"]["rec_shear"])


def test_cli_test_refuses_a_mesh_and_needs_a_card(root, tmp_path):
    # --n_devices must equal the world size: 8 devices in a process alone is refused (the data-parallel runs
    # under a launcher are tests/test_torch_parallel.py's)
    base = ["test", "--data_path", str(root), "--result_path", str(tmp_path), "--methods", "No_Deconv"]
    with pytest.raises(ValueError, match="n_devices=8, but the process group has 1 rank"):
        cli.main(base + ["--n_devices", "8", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base)
