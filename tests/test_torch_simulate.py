"""Port parity: galaxy_deconv_tpu_torch.data.simulate and generate_dataset
against the JAX simulator.

The renderers take the same numpy parameter dicts in both packages (the JAX
ones one sample at a time, the port's batched); whole batches are rendered
from JAX's own parameters and noise.  Tolerance of every render: max |port -
JAX| <= 1e-5 of max |JAX| over the batch (float32 FFTs of a 128-wide pupil
and 192-wide stamps in two libraries; the CPU reads 2e-7 to 6e-7).  The
samplers cannot share JAX's random streams, so each sampled field is held to
JAX's draws by a two-sample KS statistic.
"""

import json

import jax
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import dataset as jdataset
from galaxy_deconv_tpu.data import simulate as J
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import GalaxyDataset, generate_dataset
from galaxy_deconv_tpu_torch.data import simulate as T

SMALL = dict(pupil_n=64, pupil_pad=128)  # the small pupil of tests/test_data.py
KNOTS = dict(knot_frac_min=0.2, knot_frac_max=0.3)
REL = 1e-5
N = 6


def assert_rel(got, want, rel=REL, note=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"max |port - jax| / max |jax| = {err:.3e} > {rel}{note}"


def jax_params(key, n, **cfg):
    return jax.tree.map(np.asarray, J.sample_params(key, n, J.SimulationConfig(**cfg)))


def torch_params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def per_sample(fn, p, n):
    return np.stack([np.asarray(fn({k: v[i] for k, v in p.items()})) for i in range(n)])


@pytest.fixture(scope="module", params=[{}, KNOTS], ids=["knots_off", "knots_on"])
def drawn(request):
    cfg = {**SMALL, **request.param}
    return cfg, jax_params(jax.random.PRNGKey(3), N, **cfg)


# --- renderers on the same parameter dicts ---------------------------------------


def test_optical_autocorr_matches_jax(drawn):
    # the port's output twice, bit for bit, before it is held to JAX's: one
    # tier-1 run read 2.1e-4 here, in the first test of its worker, where
    # reruns read 1.8e-7, so a result that changes between two calls on the
    # same inputs is told apart from one that differs from JAX's every time
    # On a failure the message also names the largest error's index, both
    # sides' values there and their normalisers (the centre, pad // 2, each
    # autocorrelation is divided by), and the CPU kernels torch dispatched to,
    # so that a recurrence tells a whole array scaled from one region moved.
    cfg, p = drawn
    want = per_sample(lambda q: J.optical_autocorr(q, J.SimulationConfig(**cfg)), p, N)
    got = [T.optical_autocorr(torch_params(p), T.SimulationConfig(**cfg)) for _ in range(2)]
    err = np.abs(got[0].numpy() - np.asarray(want))
    i = tuple(int(k) for k in np.unravel_index(err.argmax(), err.shape))
    c = cfg["pupil_pad"] // 2
    context = (f"\nthreading of this process: {torch.__config__.parallel_info()}"
               f"\nlargest error at {i}: got {float(got[0][i]):.9e}, want {float(want[i]):.9e}; normaliser "
               f"acorr[:, {c}, {c}]: got {got[0][:, c, c].tolist()}, want {np.asarray(want)[:, c, c].tolist()}; "
               f"torch.backends.cpu.get_cpu_capability() {torch.backends.cpu.get_cpu_capability()}")
    assert torch.equal(got[0], got[1]), f"two calls differ by {float((got[0] - got[1]).abs().max()):.3e}{context}"
    assert_rel(got[0], want, note=context)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_optical_autocorr_matches_jax_at_thread_counts(drawn, threads):
    """The same render with torch's intra-op threads set to ``threads``: the
    float32 FFTs split their work by thread, and no split may move the
    result off JAX's (the count restored after)."""
    cfg, p = drawn
    want = per_sample(lambda q: J.optical_autocorr(q, J.SimulationConfig(**cfg)), p, N)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = T.optical_autocorr(torch_params(p), T.SimulationConfig(**cfg))
    finally:
        torch.set_num_threads(before)
    assert_rel(got, want)


def test_sample_optical_otf_matches_jax(drawn):
    """The bilinear sampling of one autocorrelation (JAX's) on sheared
    frequency grids, some shifts landing outside the grid (counted 0)."""
    cfg, p = drawn
    jcfg = J.SimulationConfig(**cfg)
    acorr = per_sample(lambda q: J.optical_autocorr(q, jcfg), p, N)
    nuy, nux = (np.asarray(a) for a in J._freq_grid(jcfg.n_hi, jcfg.scale_hi))
    scale = np.linspace(0.9, 40.0, N).astype(np.float32)  # up to 40x: shifts beyond the pupil grid
    want = np.stack([np.asarray(J.sample_optical_otf(acorr[i], nux * scale[i], nuy * scale[i],
                                                     p["lam_over_diam"][i], jcfg)) for i in range(N)])
    got = T.sample_optical_otf(torch.from_numpy(acorr), torch.from_numpy(nux * scale[:, None, None]),
                               torch.from_numpy(nuy * scale[:, None, None]),
                               torch.from_numpy(np.array(p["lam_over_diam"])), T.SimulationConfig(**cfg))
    assert (want[-1] == 0).mean() > 0.5  # the widest grid samples mostly outside
    assert_rel(got, want)


def test_bilinear_sample_matches_map_coordinates():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 7, 9)).astype(np.float32)
    y = rng.uniform(-2, 9, (2, 30)).astype(np.float32)
    x = rng.uniform(-2, 11, (2, 30)).astype(np.float32)
    want = np.stack([np.asarray(jax.scipy.ndimage.map_coordinates(img[b], [y[b], x[b]], order=1, mode="constant",
                                                                  cval=0.0)) for b in range(2)])
    got = T.bilinear_sample(torch.from_numpy(img), torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("override", ["none", "shear", "fwhm"])
def test_render_psf_matches_jax(drawn, override):
    cfg, p = drawn
    jcfg, tcfg = J.SimulationConfig(**cfg), T.SimulationConfig(**cfg)
    g1 = np.linspace(-0.05, 0.05, N).astype(np.float32) if override == "shear" else np.zeros(N, np.float32)
    g2 = -0.5 * g1
    fwhm = (p["atmos_fwhm"] + 0.1).astype(np.float32) if override == "fwhm" else None
    want = np.stack([np.asarray(J.render_psf({k: v[i] for k, v in p.items()}, jcfg, g1[i], g2[i],
                                             None if fwhm is None else fwhm[i])) for i in range(N)])
    got = T.render_psf(torch_params(p), tcfg, torch.from_numpy(g1), torch.from_numpy(g2),
                       None if fwhm is None else torch.from_numpy(fwhm))
    assert_rel(got, want)
    np.testing.assert_allclose(got.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)


def test_render_galaxy_matches_jax(drawn):
    cfg, p = drawn
    want = per_sample(lambda q: J.render_galaxy(q, J.SimulationConfig(**cfg)), p, N)
    assert_rel(T.render_galaxy(torch_params(p), T.SimulationConfig(**cfg)), want)


def test_knots_change_the_galaxy():
    p = torch_params(jax_params(jax.random.PRNGKey(3), N, **SMALL, **KNOTS))
    off = T.render_galaxy(p, T.SimulationConfig(**SMALL))
    on = T.render_galaxy(p, T.SimulationConfig(**SMALL, **KNOTS))
    assert torch.isfinite(on).all() and (on - off).abs().max() > 1e-3 * off.abs().max()


def test_observe_matches_jax():
    rng = np.random.default_rng(1)
    cfg = J.SimulationConfig(**SMALL)
    n = cfg.n_hi
    gt = np.abs(rng.standard_normal((3, n, n))).astype(np.float32) * 50
    psf = np.abs(rng.standard_normal((3, n, n))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    noise = rng.standard_normal((3, 48, 48)).astype(np.float32) * 3
    want = J.observe(gt, psf, noise, cfg)
    assert_rel(T.observe(*map(torch.from_numpy, (gt, psf, noise)), T.SimulationConfig(**SMALL)), want)


# --- whole batches from JAX's own draws --------------------------------------------


def jax_draws(key, n, cfg):
    """JAX's simulate_* split a key into (parameters, noise/signs)."""
    kp, kn = jax.random.split(key)
    params = jax.tree.map(np.asarray, J.sample_params(kp, n, cfg))
    noise = np.asarray(J.noise_sigma(cfg.pixel_scale) * jax.random.normal(kn, (n, cfg.fov_pixels, cfg.fov_pixels)))
    signs = np.asarray(jax.numpy.where(jax.random.uniform(kn, (n, 3)) > 0.5, 1.0, -1.0), np.float32)
    return params, noise, signs


@pytest.mark.parametrize("cfg", [SMALL, {**SMALL, **KNOTS}], ids=["knots_off", "knots_on"])
def test_simulate_batch_matches_jax(cfg):
    key = jax.random.PRNGKey(11)
    jcfg = J.SimulationConfig(**cfg)
    params, noise, _ = jax_draws(key, N, jcfg)
    want = jax.tree.map(np.asarray, J.simulate_batch(key, N, jcfg))
    got = T.render_batch(torch_params(params), torch.from_numpy(np.array(noise)), T.SimulationConfig(**cfg))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert_rel(got[k], want[k])


def test_simulate_batch_at_snr_matches_jax():
    key = jax.random.PRNGKey(12)
    jcfg = J.SimulationConfig(**SMALL)
    params, noise, _ = jax_draws(key, N, jcfg)
    want = jax.tree.map(np.asarray, J.simulate_batch_at_snr(key, N, 60.0, jcfg))
    tp = torch_params(params)
    tp["snr"] = torch.full((N,), 60.0)
    got = T.render_batch(tp, torch.from_numpy(np.array(noise)), T.SimulationConfig(**SMALL))
    for k in want:
        assert_rel(got[k], want[k])


@pytest.mark.parametrize("kind,err", [("shear", 0.05), ("fwhm", 0.1), ("fwhm", 0.9)])
def test_simulate_perturbed_psfs_matches_jax(kind, err):
    """fwhm_err 0.9 pushes some seeing below 0, which takes the other sign."""
    key = jax.random.PRNGKey(13)
    jcfg = J.SimulationConfig(**SMALL)
    params, _, signs = jax_draws(key, N, jcfg)
    want = np.asarray(J.simulate_perturbed_psfs(key, N, jcfg, **{f"{kind}_err": err}))
    got = T.render_perturbed_psfs(torch_params(params), torch.from_numpy(np.array(signs)), T.SimulationConfig(**SMALL),
                                  **{f"{kind}_err": err})
    assert_rel(got, want)


# --- the samplers, by distribution -------------------------------------------------

N_DRAW = 4000
# two-sample KS critical value at alpha = 1e-3 (c = 1.949) for two samples of N_DRAW
KS_MAX = 1.949 * np.sqrt(2.0 / N_DRAW)


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    both = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, both, side="right") / a.size
                        - np.searchsorted(b, both, side="right") / b.size).max())


@pytest.fixture(scope="module")
def draws():
    cfg = {**SMALL, **KNOTS}
    want = jax_params(jax.random.PRNGKey(5), N_DRAW, **cfg)
    gen, _, _ = T.chunk_generators(5, "cpu")
    got = {k: v.numpy() for k, v in T.sample_params(gen, N_DRAW, T.SimulationConfig(**cfg)).items()}
    return got, want


FIELDS = sorted(jax_params(jax.random.PRNGKey(0), 2, **SMALL))


@pytest.mark.parametrize("field", FIELDS)
def test_sampled_field_matches_jax_distribution(draws, field):
    got, want = draws
    assert got[field].shape == want[field].shape and got[field].dtype == np.float32
    assert ks_statistic(got[field].ravel(), want[field].ravel()) <= KS_MAX


def test_ks_check_rejects_a_shifted_distribution(draws):
    got, want = draws
    lo, hi = want["atmos_fwhm"].min(), want["atmos_fwhm"].max()
    assert ks_statistic(got["atmos_fwhm"] + 0.05 * (hi - lo), want["atmos_fwhm"]) > KS_MAX


def test_knot_radii_use_the_galaxys_own_half_light_radius(draws):
    got, _ = draws
    r = np.hypot(got["knot_u"], got["knot_v"])
    assert (r <= T.SimulationConfig().knot_r_scale * got["half_light_radius"][:, None] * (1 + 1e-6)).all()
    np.testing.assert_allclose(got["knot_f"].sum(axis=1), 1.0, rtol=1e-5)


def test_interp_matches_numpy():
    xp = np.array([0.0, 0.2, 0.2, 0.7, 1.0], np.float32)
    fp = np.array([1.0, 2.0, 5.0, 3.0, 3.0], np.float32)
    x = np.array([-1.0, 0.0, 0.1, 0.2, 0.25, 0.7, 0.99, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(T.interp(*map(torch.from_numpy, (x, xp, fp))).numpy(),
                               np.asarray(jax.numpy.interp(x, xp, fp)), rtol=1e-6)


# --- streams and the variant structure ---------------------------------------------


def test_same_seed_same_draws_other_seed_other_draws():
    cfg = T.SimulationConfig(**SMALL)
    a, b, c = (T.simulate_batch(s, 3, cfg, "cpu") for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["obs"], c["obs"])


def test_variants_share_scenes_and_noise():
    """simulate_batch_at_snr: the same PSFs, gt proportional, the same noise
    draw; simulate_perturbed_psfs: the same scenes, one sign draw per seed."""
    cfg = T.SimulationConfig(**SMALL)
    base = T.simulate_batch(9, 4, cfg, "cpu")
    at = T.simulate_batch_at_snr(9, 4, 100.0, cfg, "cpu")
    assert torch.equal(base["psf"], at["psf"]) and (at["snr"] == 100.0).all()
    ratio = at["gt"] / base["gt"].clamp_min(1e-30)
    want = (100.0 / base["snr"])[:, None, None].expand_as(ratio)
    mask = base["gt"] > 1e-3 * base["gt"].amax(dim=(1, 2), keepdim=True)
    torch.testing.assert_close(ratio[mask], want[mask], rtol=1e-5, atol=0)
    pgen, ngen, sgen = T.chunk_generators(9, "cpu")
    params, noise = T.sample_params(pgen, 4, cfg), T.draw_noise(ngen, 4, cfg)
    clean = T.render_batch(params, torch.zeros_like(noise), cfg)["obs"]
    torch.testing.assert_close(base["obs"] - clean, noise, rtol=0, atol=1e-4)
    params["snr"] = torch.full((4,), 100.0)
    torch.testing.assert_close(at["obs"] - T.render_batch(params, torch.zeros_like(noise), cfg)["obs"], noise,
                               rtol=0, atol=1e-4)
    pert = T.simulate_perturbed_psfs(9, 4, cfg, shear_err=0.05, device="cpu")
    assert not torch.allclose(pert, base["psf"])
    rel = (pert - base["psf"]).norm(dim=(1, 2)) / base["psf"].norm(dim=(1, 2))
    assert (rel < 0.2).all()
    torch.testing.assert_close(T.simulate_perturbed_psfs(9, 4, cfg, device="cpu"), base["psf"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's tree twice from one seed, and the JAX package's."""
    kw = dict(n_train=4, n_test=4, chunk=4, snrs=(20, 100), shear_errs=(0.02,), fwhm_errs=(0.05,), verbose=False)
    tmp = tmp_path_factory.mktemp("trees")
    a = generate_dataset(tmp / "a", cfg=T.SimulationConfig(**SMALL), device="cpu", **kw)
    b = generate_dataset(tmp / "b", cfg=T.SimulationConfig(**SMALL), device="cpu", **kw)
    j = jdataset.generate_dataset(tmp / "j", cfg=J.SimulationConfig(**SMALL), **kw)
    return a, b, j


def files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.npy"))


def test_generate_dataset_writes_the_jax_layout(trees):
    a, _, j = trees
    assert files(a) == files(j)
    for name in files(j):
        x, y = np.load(a / name), np.load(j / name)
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, name
    info_a, info_j = (json.loads((r / "info.json").read_text()) for r in (a, j))
    assert info_a.keys() == info_j.keys()
    assert info_a["generator"] == "galaxy_deconv_tpu_torch.data.simulate"
    assert {k: v for k, v in info_a.items() if k != "generator"} == {k: v for k, v in info_j.items()
                                                                    if k != "generator"}


def test_generate_dataset_same_seed_same_files(trees):
    a, b, _ = trees
    for name in files(a):
        assert np.array_equal(np.load(a / name), np.load(b / name)), name


def test_generate_dataset_variant_structure(trees):
    """The test split's PSFs serve every SNR variant; gt_{snr} is the test
    split's gt scaled to that SNR; the train split holds other galaxies."""
    a, _, _ = trees
    test = GalaxyDataset(a, "test")
    for snr in (20, 100):
        v = GalaxyDataset(a, "test", obs_variant=f"obs_{snr}")
        assert np.array_equal(v.psf, test.psf)
        scale = snr / np.load(a / "test" / "snr.npy")
        np.testing.assert_allclose(v.gt, test.gt * scale[:, None, None], rtol=1e-5, atol=1e-6 * np.abs(v.gt).max())
    p = GalaxyDataset(a, "test", psf_variant="psf_shear_err_0.02")
    assert p.psf.shape == test.psf.shape and not np.array_equal(p.psf, test.psf)
    train = GalaxyDataset(a, "train")
    assert not np.isin(np.load(a / "train" / "gal_g1.npy"), np.load(a / "test" / "gal_g1.npy")).any()
    assert len(train) == 4 and len(test) == 4


def test_dataset_variant_falls_back_to_gt(trees, tmp_path):
    a, _, _ = trees
    import shutil

    shutil.copytree(a, tmp_path / "c")
    (tmp_path / "c" / "test" / "gt_20.npy").unlink()
    v = GalaxyDataset(tmp_path / "c", "test", obs_variant="obs_20")
    assert np.array_equal(v.gt, np.load(a / "test" / "gt.npy"))
    b = v.batch(np.arange(3))
    np.testing.assert_allclose(b["alpha"], b["obs"].mean(axis=(1, 2)), rtol=1e-6)


def test_cli_generate_refuses_denoise_and_needs_a_card(tmp_path):
    """``--task Denoise`` generates (the name is kept from when it was refused),
    and the default device is the card."""
    root = cli.main(["generate", "--data_path", str(tmp_path / "dn"), "--task", "Denoise", "--n_train", "2",
                     "--n_test", "1", "--pupil_n", "8", "--device", "cpu"])
    assert json.loads((root / "info.json").read_text())["task"] == "Denoise"
    assert np.load(root / "train" / "gt.npy").shape == (2, 48, 48)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["generate", "--data_path", str(tmp_path / "d"), "--n_train", "1", "--n_test", "1",
                      "--pupil_n", "8"])
