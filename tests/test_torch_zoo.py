"""Port parity: the model zoo of galaxy_deconv_tpu_torch (the XDenseUNet and
its blocks, the rest of ``ops/fourier.py``, Tikhonet, the two-dual
UnrolledADMM, ADMMNet, the ResUNet denoiser), the denoising task's data and
the commands that reach them, against the JAX package on the same numpy
inputs with the weights carried by the bridge.  Their training pieces are in
tests/test_torch_zoo_train.py, the trained checkpoints in
tests/test_torch_zoo_trained.py.

Tolerances: nets and Fourier helpers at rtol 1e-5, atol 1e-5 x max |want|;
whole models at tests/test_torch_model.py's full-model rtol 1e-4, atol 5e-4,
on outputs divided by alpha where the model multiplies by it; each data test
states its own.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import dataset as jdataset
from galaxy_deconv_tpu.data import simulate as J
from galaxy_deconv_tpu.models import denoiser as jdenoiser
from galaxy_deconv_tpu.models import registry as jregistry
from galaxy_deconv_tpu.models import tikhonet as jtikhonet
from galaxy_deconv_tpu.models import unrolled_admm as jadmm
from galaxy_deconv_tpu.nets import blocks as jblocks
from galaxy_deconv_tpu.nets import xdense_unet as jxdense
from galaxy_deconv_tpu.ops import fourier as jfourier
from galaxy_deconv_tpu.ops import resize as jresize
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import FIELDS as T_FIELDS
from galaxy_deconv_tpu_torch.data import GalaxyDataset, generate_dataset_denoise, load_reference_pth_dataset
from galaxy_deconv_tpu_torch.data import simulate as T
from galaxy_deconv_tpu_torch.eval import make_apply_fn
from galaxy_deconv_tpu_torch.models import ADMMNet, ResUNetDenoiser, Tikhonet, UnrolledADMM, build_model
from galaxy_deconv_tpu_torch.models import unrolled_admm as tadmm
from galaxy_deconv_tpu_torch.models.tikhonet import tikhonov_solve
from galaxy_deconv_tpu_torch.nets import SeparableConv, XDenseUNet
from galaxy_deconv_tpu_torch.ops import fourier
from galaxy_deconv_tpu_torch.ops.resize import upsample_nearest
from galaxy_deconv_tpu_torch.train import create_train_state
from galaxy_deconv_tpu_torch.utils.convert_flax import conv_weight, model_state_dict

NET_RTOL, NET_ATOL = 1e-5, 1e-5  # atol in units of max |want|
RTOL, ATOL = 1e-4, 5e-4
SMALL = dict(n_iters=2, features=(8, 16, 32, 64))  # tests/test_solvers.py's size
SMALL_SIM = dict(pupil_n=64, pupil_pad=128)


def jit(fn):
    """``jax.jit(fn)``, compiled at its first call's shapes with XLA's CPU
    backend optimisation level 0: the full-width XDenseUNet compiles in half
    the time, and each compiled function here runs a few times at most.  The
    level steers LLVM's passes over the generated loops, so JAX's float32
    rounding differs from the default compile's (summation order; the
    convolutions are library calls either way); the forward tolerances hold
    for both."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return call


def as_np(tree):
    return jax.tree.map(np.array, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return t(np.asarray(a).transpose(0, 3, 1, 2))


def assert_net_close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=NET_ATOL * np.abs(want).max())


@pytest.fixture
def rng():
    return np.random.default_rng(43)


@pytest.fixture(scope="module")
def stamps(fixtures_dir):
    """The reference's golden stamp and two simulated ones (the port's
    simulator, small pupil): obs, psf and alpha = mean(obs), as the readers give."""
    g = np.load(fixtures_dir / "solver_goldens.npz")
    b = T.simulate_batch(5, 2, T.SimulationConfig(**SMALL_SIM), "cpu")
    obs = np.concatenate([g["obs"][None], b["obs"].numpy()])
    psf = np.concatenate([g["psf"][None], b["psf"].numpy()])
    return obs, psf, obs.mean(axis=(1, 2))


def variables(jm, *args, seed=0):
    """Variables for the flax module ``jm`` called on ``args``: flax's tree
    (``jax.eval_shape`` of ``init``, no compilation) filled from numpy
    ``seed``: kernels N(0, 1/fan_in) and the other biases 0 as flax draws
    them; BatchNorm biases, means and the learnt scalars 0.1 N(0, 1),
    BatchNorm scales and variances U(0.5, 1.5).  An un-jitted ``init`` of
    these models takes 30-100 s on the CPU.  (Conv biases in front of
    train-mode BatchNorm, random instead of 0, make its E[x^2] - E[x]^2
    cancel, which both frameworks round differently.)"""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name, parent = path[-1].key, getattr(path[-2], "key", "") if len(path) > 1 else ""
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "bias" and not parent.startswith("BatchNorm"):
            return np.zeros(leaf.shape, np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args))


# --- nets and ops ---------------------------------------------------------------------


def test_upsample_nearest_matches_jax(rng):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    for factor in (2, 3):
        want = np.asarray(jresize.upsample_nearest(x, factor)).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(upsample_nearest(nchw(x), factor).numpy(), want)


def test_separable_conv_matches_flax(rng):
    x = rng.standard_normal((2, 12, 12, 6)).astype(np.float32)
    jm = jblocks.SeparableConv(5)
    p = as_np(jm.init(jax.random.PRNGKey(1), x))["params"]
    assert p["Conv_0"]["kernel"].shape == (3, 3, 1, 6)  # depthwise: feature_group_count = 6
    tm = SeparableConv(6, 5)
    tm.load_state_dict({"depthwise.weight": t(conv_weight(p["Conv_0"]["kernel"])),
                        "pointwise.weight": t(conv_weight(p["Conv_1"]["kernel"]))})
    want = np.asarray(jm.apply({"params": p}, x)).transpose(0, 3, 1, 2)
    assert_net_close(tm(nchw(x)), want)


def test_xdense_unet_widths():
    """The channel widths of JAX's comments (xdense_unet.py:74-90), which decide
    whether the bridge's weights line up: encoder 112/220/352, body 296 -> 84,
    decoder 508 -> 72, 352 -> 60, 220 -> 1; 397,113 parameters."""
    m = XDenseUNet()
    assert [b.out_features for b in m.blocks] == [112, 220, 352, 296, 508, 352, 220]
    assert [b.norms[0].num_features for b in m.blocks] == [32, 80, 140, 212, 436, 292, 172]
    assert [(u.conv.in_channels, u.conv.out_channels) for u in m.ups] == [(296, 84), (508, 72), (352, 60)]
    assert [(d.conv.in_channels, d.conv.out_channels) for d in m.downs] == [(112, 80), (220, 140), (352, 212)]
    assert (m.tail.in_channels, m.tail.out_channels) == (220, 1)
    assert sum(p.numel() for p in m.parameters()) == 397_113


@pytest.fixture(scope="module")
def xdense_variables():
    return variables(jxdense.XDenseUNet(), np.zeros((1, 48, 48, 1), np.float32))


def xdense_pair(rng, v, B=2):
    x = rng.standard_normal((B, 48, 48, 1)).astype(np.float32)
    jm = jxdense.XDenseUNet()
    tm = XDenseUNet()
    tm.load_state_dict(xdense_state_dict(v["params"], v["batch_stats"]))
    return x, jm, v, tm


def xdense_state_dict(params, stats):
    """The bridge's entries for a bare XDenseUNet (without the solvers' prefix)."""
    sd = model_state_dict({"XDenseUNet_0": params}, {"XDenseUNet_0": stats})
    return {k.removeprefix("xdense_unet."): v for k, v in sd.items()}


def test_xdense_unet_eval_matches_flax(rng, xdense_variables):
    x, jm, v, tm = xdense_pair(rng, xdense_variables)
    want = np.asarray(jit(jm.apply)(v, x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        assert_net_close(tm.eval()(nchw(x)), want)


def test_xdense_unet_train_mode_matches_flax(rng, xdense_variables):
    """Batch statistics in the forward, and the running statistics after it
    (flax momentum 0.9) at the nets' tolerance."""
    x, jm, v, tm = xdense_pair(rng, xdense_variables, B=3)
    want, upd = jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        got = tm.train()(nchw(x))
    assert_net_close(got, np.asarray(want).transpose(0, 3, 1, 2))
    stats = xdense_state_dict(v["params"], as_np(upd["batch_stats"]))
    sd = tm.state_dict()
    running = [k for k in stats if "running_" in k]
    assert len(running) == 2 * 40  # 37 dense-block layers and 3 downs
    for k in running:
        assert not torch.equal(stats[k], xdense_state_dict(v["params"], v["batch_stats"])[k])  # they moved
        assert_net_close(sd[k], stats[k].numpy())


@pytest.mark.parametrize("fn", ["laplacian_kernel", "laplacian_otf_reference_quirk", "conv_fft_symm",
                                "conv_fft_full"])
def test_fourier_matches_jax(rng, fn):
    x = rng.standard_normal((2, 48, 40)).astype(np.float32)
    if fn == "laplacian_kernel":
        got, want = fourier.laplacian_kernel(), jfourier.laplacian_kernel()
    elif fn == "laplacian_otf_reference_quirk":
        got, want = fourier.laplacian_otf_reference_quirk((48, 40)), jfourier.laplacian_otf_reference_quirk((48, 40))
        assert abs(complex(want[0, 0])) == 2.0  # six +1 taps and one -4: |L(0)| = 2
    elif fn == "conv_fft_symm":
        psf = np.abs(rng.standard_normal((2, 5, 5))).astype(np.float32)
        got, want = fourier.conv_fft_symm(t(psf), t(x)), jfourier.conv_fft_symm(psf, x)
    else:
        otf = (rng.standard_normal((2, 48, 40)) + 1j * rng.standard_normal((2, 48, 40))).astype(np.complex64)
        got, want = fourier.conv_fft_full(t(otf), t(x)), jfourier.conv_fft_full(otf, x)
    assert got.dtype == (torch.complex64 if fn == "laplacian_otf_reference_quirk" else torch.float32)
    assert_net_close(got, want)


def v_inputs(rng):
    shape = (2, 16, 16)
    v_tilde = rng.standard_normal(shape).astype(np.float32) * 2
    y = np.abs(rng.standard_normal(shape)).astype(np.float32) * 30
    rho = rng.uniform(0.05, 3, (2, 1, 1)).astype(np.float32)
    alpha = rng.uniform(1, 100, (2, 1, 1)).astype(np.float32)
    return v_tilde, y, rho, alpha


@pytest.mark.parametrize("fn", ["v_update_poisson", "v_update_poisson_exact", "v_update_gaussian",
                                "soft_threshold"])
def test_elementwise_updates_match_jax(rng, fn):
    v_tilde, y, rho, alpha = v_inputs(rng)
    if fn == "v_update_poisson_exact":
        v_tilde[0, :8] = 40.0  # rho * v_tilde > alpha somewhere: the where's other branch
    args = {"v_update_gaussian": (v_tilde, y, rho), "soft_threshold": (v_tilde, np.float32(0.7), rho)}.get(
        fn, (v_tilde, y, rho, alpha))
    want = np.asarray(getattr(jadmm, fn)(*map(jnp.asarray, args)))
    got = getattr(tadmm, fn)(*map(t, args))
    if fn == "v_update_poisson_exact":
        t1 = rho * v_tilde - alpha
        assert (t1 > 0).any() and (t1 <= 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=NET_RTOL, atol=NET_ATOL * np.abs(want).max())


# --- whole models at the JAX tests' size --------------------------------------------


def bridged(jm, tm, obs, psf, alpha, edit=None, v=None):
    """Seeded variables for ``jm`` (or ``v``; ``edit`` may change them),
    carried into ``tm``; both models' eval outputs."""
    v = variables(jm, obs, psf, alpha) if v is None else v
    if edit:
        edit(v)
    tm.load_state_dict(model_state_dict(v["params"], v.get("batch_stats")))
    want = np.asarray(jit(jm.apply)(v, *map(jnp.asarray, (obs, psf, alpha))))
    with torch.no_grad():
        got = tm.eval()(*map(t, (obs, psf, alpha))).numpy()
    return got, want, v


def assert_model_close(got, want, alpha=None):
    if alpha is not None:
        got, want = got / alpha[:, None, None], want / alpha[:, None, None]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def tikhonet_variables(stamps):
    """One tree serves every filter: lam_raw and the XDenseUNet."""
    return variables(jtikhonet.Tikhonet(), *stamps)


@pytest.mark.parametrize("filter,laplacian", [("Identity", "reference"), ("Laplacian", "reference"),
                                              ("Laplacian", "exact"), ("Identity", "exact")])
def test_tikhonet_matches_flax(stamps, tikhonet_variables, filter, laplacian):
    obs, psf, alpha = stamps
    got, want, _ = bridged(jtikhonet.Tikhonet(filter=filter, laplacian=laplacian),
                           Tikhonet(filter=filter, laplacian=laplacian), obs, psf, alpha, v=tikhonet_variables)
    assert_model_close(got, want, alpha)
    # the Tikhonov solve alone, at a lam other than 1
    lam = np.float32(0.37)
    solve_want = np.asarray(jtikhonet.tikhonov_solve(obs, psf, alpha, lam, filter, laplacian))
    assert_net_close(tikhonov_solve(t(obs), t(psf), t(alpha), t(lam), filter, laplacian), solve_want)


def test_tikhonov_solve_rejects_unknown_filter(stamps):
    obs, psf, alpha = stamps
    with pytest.raises(ValueError, match="unknown Tikhonov filter"):
        tikhonov_solve(t(obs), t(psf), t(alpha), torch.tensor(1.0), "Gaussian")


ADMM_CASES = {
    "poisson": dict(llh="Poisson"),
    "gaussian": dict(llh="Gaussian"),
    "l1_learnt_rho": dict(llh="Poisson", pnp=False, subnet=False),
    "xdense_unet": dict(llh="Poisson", denoiser="XDenseUNet"),
}


@pytest.mark.parametrize("case", list(ADMM_CASES))
def test_unrolled_admm_matches_flax(stamps, case):
    kw = {**SMALL, **ADMM_CASES[case]}
    obs, psf, alpha = stamps

    def schedule(v):  # a learnt schedule and threshold other than the initial ones
        v["params"].update(rho1_iters=np.array([0.4, 1.3], np.float32), rho2_iters=np.array([2.0, 0.6], np.float32),
                           lam_raw=np.float32(-1.5))

    got, want, _ = bridged(jadmm.UnrolledADMM(**kw), UnrolledADMM(**kw), obs, psf, alpha,
                           schedule if case == "l1_learnt_rho" else None)
    assert_model_close(got, want, alpha if kw["llh"] == "Poisson" else None)


@pytest.mark.parametrize("name", ["ADMMNet", "ADMMNet_scaled", "ADMMNet_fixed"])
def test_admmnet_matches_flax(stamps, name):
    got, want, _ = bridged(jregistry.build_model(name, **SMALL), build_model(name, **SMALL), *stamps)
    assert_model_close(got, want, stamps[2])


def test_admmnet_rejects_unknown_options():
    with pytest.raises(ValueError, match="denoiser_scale must be 'unit' or 'adu'"):
        ADMMNet(denoiser_scale="raw")
    with pytest.raises(ValueError, match="poisson_prox must be 'reference' or 'exact'"):
        ADMMNet(poisson_prox="approx")


def test_resunet_denoiser_matches_flax(stamps):
    obs, psf, alpha = stamps
    got, want, _ = bridged(jdenoiser.ResUNetDenoiser(features=SMALL["features"]),
                           ResUNetDenoiser(features=SMALL["features"]), obs, psf, alpha)
    assert_model_close(got, want)
    # psf and alpha are ignored
    model = build_model("ResUNet", features=SMALL["features"])
    with torch.no_grad():
        assert torch.equal(model(t(obs)), model(t(obs), t(psf) * 0, t(alpha) * 7))


# --- from-seed weights -------------------------------------------------------------


def test_zoo_scalars_start_at_flax_values(stamps):
    """init_parameters leaves each learnt scalar at flax's initial value, and
    make_apply_fn's seed-0 path builds create_train_state's seed-0 weights."""
    tik = build_model("Tikhonet_Laplacian")
    create_train_state(tik, 0)
    assert float(torch.nn.functional.softplus(tik.lam_raw.detach())) == pytest.approx(1.0, rel=1e-6)
    admm = UnrolledADMM(n_iters=3, pnp=False, subnet=False)
    with torch.no_grad():
        admm.rho1_iters.fill_(5.0)
        admm.lam_raw.fill_(5.0)
    create_train_state(admm, 0)
    assert torch.equal(admm.rho1_iters, torch.ones(3)) and torch.equal(admm.rho2_iters, torch.ones(3))
    assert float(admm.lam_raw.detach()) == 0.0
    # the depthwise convolutions' fan-in is their 9 taps, as flax's lecun_normal
    # with feature_group_count = C: scaled by 3, std 1 and within the truncation
    dw = torch.cat([m.depthwise.weight.detach().ravel() for m in tik.modules() if isinstance(m, SeparableConv)]) * 3
    assert float(dw.abs().max()) <= 2.2743 and abs(float(dw.std()) - 1) <= 0.02
    # make_apply_fn(seed 0) and create_train_state(seed 0) build the same weights
    for name in ("Tikhonet_Laplacian", "Unrolled_ADMM(2)"):
        kw = {} if name.startswith("Tikhonet") else {"features": SMALL["features"]}
        model = build_model(name, **kw)
        create_train_state(model, 0)
        obs, psf, alpha = stamps
        with torch.no_grad():
            want = model.eval()(*map(t, (obs, psf, alpha)))
        got = make_apply_fn(name, device="cpu", **kw)(*map(t, (obs, psf, alpha)))
        assert torch.equal(got, want), name


# --- the denoising task's data ------------------------------------------------------


def test_denoise_render_matches_jax():
    """The denoising render from JAX's own draws: parameters, the SNR's uniform
    (fold_in 55 of the parameter key) and the noise; every field at 1e-5 of
    its peak, and the unit-scale variant too."""
    key, n = jax.random.PRNGKey(21), 5
    jcfg = J.SimulationConfig(**SMALL_SIM)
    kp, kn = jax.random.split(key)
    params = as_np(jit(lambda k: J.sample_params(k, n, jcfg))(kp))
    u = np.asarray(jax.random.uniform(jax.random.fold_in(kp, 55), (n,)))
    p, lo, hi = 0.44, 18.0, 320.0
    snr = (u * (hi ** (1 - p) - lo ** (1 - p)) + lo ** (1 - p)) ** (1.0 / (1 - p))
    noise = np.asarray(J.noise_sigma(jcfg.pixel_scale) * jax.random.normal(kn, (n, 48, 48)))
    want = as_np(jit(lambda k: J.simulate_batch_denoise(k, n, jcfg))(key))
    got = T.render_batch_denoise({k: t(v) for k, v in params.items()}, t(snr.astype(np.float32)), t(noise),
                                 T.SimulationConfig(**SMALL_SIM))
    unit_want = as_np(jit(lambda k: J.simulate_batch_denoise_unit(k, n, jcfg))(key))
    unit_got = T.to_unit_scale(got)
    assert set(got) == set(want) and not want["psf"].any()
    for k in want:
        for g, w in ((got[k], want[k]), (unit_got[k], unit_want[k])):
            assert g.dtype == torch.float32 and g.shape == w.shape, k
            if w.any():
                err = np.abs(g.numpy() - w).max() / np.abs(w).max()
                assert err <= 1e-5, f"{k}: {err:.3e}"
            else:
                assert not g.any(), k


def test_denoise_snr_draw_matches_jax_distribution():
    """The SNR draw against JAX's by the two-sample KS statistic of
    tests/test_torch_simulate.py (alpha = 1e-3 critical value)."""
    n = 4000
    jcfg = J.SimulationConfig(**SMALL_SIM)
    # jitted for its "snr" alone: XLA drops the renders, which nothing reads
    want = np.asarray(jax.jit(lambda k: J.simulate_batch_denoise(k, n, jcfg)["snr"])(jax.random.PRNGKey(4)))
    gen, _, _ = T.chunk_generators(4, "cpu")
    got = T.draw_denoise_snr(gen, n).numpy()
    a, b = np.sort(got), np.sort(want)
    both = np.concatenate([a, b])
    ks = np.abs(np.searchsorted(a, both, side="right") / n - np.searchsorted(b, both, side="right") / n).max()
    assert got.min() >= 18.0 and got.max() <= 320.0
    assert ks <= 1.949 * np.sqrt(2.0 / n)
    assert np.abs(np.sort(got * 1.1) - b).max() > 0 and (
        np.abs(np.searchsorted(np.sort(got * 1.1), both, side="right") / n
               - np.searchsorted(b, both, side="right") / n).max() > 1.949 * np.sqrt(2.0 / n))


def test_generate_dataset_denoise_writes_the_jax_layout(tmp_path):
    kw = dict(n_train=3, n_test=2, chunk=2, verbose=False)
    a = generate_dataset_denoise(tmp_path / "a", cfg=T.SimulationConfig(**SMALL_SIM), device="cpu", **kw)
    j = jdataset.generate_dataset_denoise(tmp_path / "j", cfg=J.SimulationConfig(**SMALL_SIM), **kw)
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*.npy"))
    assert files == sorted(str(p.relative_to(j)) for p in j.rglob("*.npy"))
    for name in files:
        x, y = np.load(a / name), np.load(j / name)
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32 and np.isfinite(x).all(), name
    info_a, info_j = (json.loads((r / "info.json").read_text()) for r in (a, j))
    assert info_a["task"] == "Denoise" and info_a["generator"] == "galaxy_deconv_tpu_torch.data.simulate"
    assert {k: v for k, v in info_a.items() if k != "generator"} == {k: v for k, v in info_j.items()
                                                                    if k != "generator"}
    ds = GalaxyDataset(a, "train")
    b = ds.batch(np.arange(3))
    assert not b["psf"].any() and (b["gt"] > 0).any()
    snr = np.load(a / "train" / "snr.npy")
    np.testing.assert_allclose(np.sqrt((b["gt"] ** 2).sum(axis=(1, 2))) / T.noise_sigma(), snr, rtol=1e-5)


def test_load_reference_pth_dataset(tmp_path, rng):
    """The reference's per-sample .pth layout, written here, packed as the JAX
    converter packs it."""
    src = tmp_path / "ref"
    n_train, n_test = 3, 2
    data = {k: rng.standard_normal((n_train + n_test, 48, 48)).astype(np.float32) for k in ("obs", "psf", "gt")}
    for k, arr in data.items():
        (src / k).mkdir(parents=True)
        for i, a in enumerate(arr):
            torch.save(torch.from_numpy(a), src / k / f"{k}_{i}.pth")
    (src / "info.json").write_text(json.dumps({"n_train": n_train, "n_test": n_test, "sequence": [0]}))
    for train, limit in ((True, None), (False, 1)):
        out = load_reference_pth_dataset(src, tmp_path / "port", train=train, limit=limit)
        want = jdataset.load_reference_pth_dataset(src, tmp_path / "jax", train=train, limit=limit)
        split = "train" if train else "test"
        names = sorted(p.name for p in (want / split).iterdir())
        assert sorted(p.name for p in (out / split).iterdir()) == names
        for name in names:
            np.testing.assert_array_equal(np.load(out / split / name), np.load(want / split / name))
    lo = n_train
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "test" / "obs.npy"), data["obs"][lo:lo + 1])
    info = json.loads((tmp_path / "port" / "info.json").read_text())
    assert info["converted_from"] == str(src) and info["n_train"] == n_train


# --- commands ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A small Deconv tree and a small Denoise tree, both from ``cli generate``."""
    tmp = tmp_path_factory.mktemp("cli")
    common = ["--n_train", "10", "--n_test", "2", "--pupil_n", "16", "--chunk", "8", "--device", "cpu"]
    cli.main(["generate", "--data_path", str(tmp / "deconv"), "--errs", "0.02", *common])
    cli.main(["generate", "--task", "Denoise", "--data_path", str(tmp / "denoise"), *common])
    return {"Deconv": tmp / "deconv", "Denoise": tmp / "denoise"}


def test_cli_generate_denoise(trees):
    root = trees["Denoise"]
    info = json.loads((root / "info.json").read_text())
    assert info["task"] == "Denoise" and info["n_train"] == 10
    assert sorted(p.name for p in (root / "train").iterdir()) == sorted(f"{k}.npy" for k in T_FIELDS)
    assert np.load(root / "train" / "obs.npy").shape == (10, 48, 48)
    assert not np.load(root / "test" / "psf.npy").any()


@pytest.mark.parametrize("model,task,name", [("ResUNet", "Denoise", "ResUNet_MultiScale"),
                                             ("Tikhonet", "Deconv", "Tikhonet_Laplacian_MultiScale")])
def test_cli_train_zoo_one_epoch(trees, tmp_path, model, task, name):
    save = tmp_path / "models"
    state, hist = cli.main(["train", "--model", model, "--data_path", str(trees[task]), "--model_save_path",
                            str(save), "--n_epochs", "1", "--batch_size", "4", "--seed", "0", "--device", "cpu"])
    assert isinstance(state.model, ResUNetDenoiser if model == "ResUNet" else Tikhonet)
    assert (save / f"{name}_1epochs" / "train_state.pt").is_file()
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all() and state.step == 2


def test_cli_test_runs_zoo_names(trees, tmp_path):
    """cli test with zoo names (seed-0 weights), and with a port checkpoint of
    a ResUNet, which ADMMNet loads as it is (the same ``resunet.`` keys)."""
    from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint

    base = ["test", "--data_path", str(trees["Deconv"]), "--test", "shear", "--snrs", "20", "--n_gal", "2",
            "--eval_batch_size", "2", "--device", "cpu"]
    methods = ["Tikhonet", "ShapeNet", "Unrolled_ADMM(1)", "ResUNet"]
    out = cli.main(base + ["--result_path", str(tmp_path / "res"), "--methods", *methods])
    for m in methods:
        assert np.shape(out[m]["20"]["rec_shear"]) == (2, 3) and np.isfinite(out[m]["20"]["rec_shear"]).all(), m
    state, _ = create_train_state(ResUNetDenoiser(), 3)
    save_checkpoint(tmp_path / "models", "ResUNet_MultiScale", 1, state)
    out = cli.main(base + ["--result_path", str(tmp_path / "res2"), "--methods", "ADMMNet_fixed(1)",
                           "--model_save_path", str(tmp_path / "models"), "--checkpoint_name", "ResUNet_MultiScale"])
    assert np.isfinite(out["ADMMNet_fixed(1)"]["20"]["rec_shear"]).all()
