"""Port parity: galaxy_deconv_tpu_torch.models.UnrolledADMMGaussian against the
flax model with the same weights (carried across by utils/convert_flax.py),
at the full-model tolerance of tests/test_dft.py: rtol 1e-4, atol 5e-4, and
with bf16 nets against flax's bf16 nets at the measured limits below.  The
trained flagship checkpoint in trained/ is carried across and held against
the JAX package on the reference's tutorial stamp in both dtypes."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.metrics import estimate_shear as jestimate_shear
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu_torch.metrics import estimate_shear
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.pipeline import build_pipeline
from galaxy_deconv_tpu_torch.utils import model_state_dict

RTOL, ATOL = 1e-4, 5e-4
FLAGSHIP = ("Gaussian_PnP_ADMM_8iters_MultiScale", 7000)
# bf16 nets against flax's bf16 nets.  The frameworks round bf16 convolutions
# differently (on the CPU 17 % of one ResBlock's outputs differ by more than
# one bf16 ulp), so the two runs differ about as much as bf16 differs from
# fp32.  Limit on max |port - flax| / max |flax| of each trace.  Readings on
# the CPU: narrow nets 4.0e-3 to 3.2e-2 (flax's own bf16 against its fp32:
# 5.7e-3 to 2.1e-2); flagship checkpoint on the tutorial stamp 2.3e-2 (1.0e-2).
BF16_REL = 6e-2
# |g_port - g_flax| of the flagship's bf16 reconstructions.  Reading 1.3e-3
# (flax's own bf16 against its fp32: 9.2e-4); figures/bf16_parity.json's rms
# shear error of 2000 galaxies is 1.1e-2 to 6.4e-2 in either dtype.
BF16_SHEAR_ATOL = 5e-3


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def inputs(rng, B=2):
    y = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 20
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    alpha = rng.uniform(20, 100, B).astype(np.float32)
    return y, psf, alpha


def as_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def both(rng, subnet=True, rho_bounds=None, analysis=False, fft_impl="fft", bf16=False):
    """The flax model with seeded weights, and the port's model with the same
    ones; ``bf16`` runs both models' nets in bfloat16."""
    y, psf, alpha = inputs(rng)
    kw = dict(n_iters=2, features=(8, 8, 16, 16), subnet=subnet, rho_bounds=rho_bounds, analysis=analysis)
    jm = JModel(**kw, fft_impl={"fft": "xla", "matmul": "matmul"}[fft_impl], dtype=jnp.bfloat16 if bf16 else jnp.float32)
    v = as_np(jm.init(jax.random.PRNGKey(0), y, psf, alpha))
    if not subnet:  # a non-trivial learnable schedule
        v["params"]["rho_iters"] = np.array([0.3, 1.7], np.float32)
    tm = UnrolledADMMGaussian(**kw, fft_impl=fft_impl, dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(model_state_dict(v["params"], v.get("batch_stats")))
    want = jm.apply(v, jnp.asarray(y), jnp.asarray(psf), jnp.asarray(alpha))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, (y, psf, alpha)))
    return got, want


@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
@pytest.mark.parametrize("subnet,rho_bounds", [(True, None), (False, None), (True, (0.05, 5.0))])
def test_forward_matches_flax(rng, fft_impl, subnet, rho_bounds):
    got, want = both(rng, subnet=subnet, rho_bounds=rho_bounds, fft_impl=fft_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def assert_traces_close(got, want, rel):
    assert set(got) == set(want) == {"x", "z", "u", "rho"}
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape
        err = np.abs(got[k].numpy() - w).max() / np.abs(w).max()
        assert err <= rel, f"{k}: max |port - flax| / max |flax| = {err:.3e} > {rel}"


@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
@pytest.mark.parametrize("subnet,rho_bounds", [(True, None), (False, None), (True, (0.05, 5.0))])
def test_bf16_nets_match_flax_bf16(rng, fft_impl, subnet, rho_bounds):
    got, want = both(rng, subnet=subnet, rho_bounds=rho_bounds, analysis=True, fft_impl=fft_impl, bf16=True)
    assert_traces_close(got, want, BF16_REL)


def test_analysis_traces_match_flax(rng):
    got, want = both(rng, analysis=True)
    assert set(got) == set(want) == {"x", "z", "u", "rho"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL)


def test_bf16_nets_keep_fp32_spectra(rng):
    y, psf, alpha = inputs(rng)
    pipes = {dt: build_pipeline("cpu", dtype=dt, n_iters=2, features=(8, 8, 16, 16))
             for dt in (torch.float32, torch.bfloat16)}
    assert pipes[torch.bfloat16].model.resunet.head.weight.dtype == torch.bfloat16
    recs = {dt: p.reconstruct(y, psf, alpha) for dt, p in pipes.items()}
    assert all(r.dtype == torch.float32 and torch.isfinite(r).all() for r in recs.values())
    scale = recs[torch.float32].abs().max()
    assert (recs[torch.bfloat16] - recs[torch.float32]).abs().max() < 0.1 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_runs_with_tf32_off_and_restores_flags(rng, dtype):
    # the caller turns TF32 on; inside the model's forward both flags read
    # False in Pipeline.reconstruct and Pipeline.__call__ (whatever the nets'
    # type: the spectra are float32), and after each call the caller's True is
    # back
    y, psf, alpha = inputs(rng)
    pipe = build_pipeline("cpu", dtype=dtype, n_iters=2, features=(8, 8, 16, 16))

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    seen, after = [], []
    pipe.model.register_forward_hook(lambda *_: seen.append(flags()))
    before = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for call in (pipe.reconstruct, pipe):
            call(y, psf, alpha)
            after.append(flags())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, False)] * 2
    assert after == [(True, True)] * 2


def test_unknown_fft_impl_raises():
    with pytest.raises(ValueError):
        UnrolledADMMGaussian(n_iters=1, features=(8, 8, 8, 8), fft_impl="xla")


def test_cuda_entry_point_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build_pipeline()


@pytest.fixture(scope="module")
def flagship(fixtures_dir):
    """The trained flagship's flax variables (numpy), the port's state_dict
    from the bridge, and the tutorial stamp (obs, psf, alpha)."""
    from galaxy_deconv_tpu.train.checkpoint import restore_checkpoint, unpack_variables

    trained = pathlib.Path(__file__).resolve().parent.parent / "trained"
    v = as_np(unpack_variables(restore_checkpoint(trained, *FLAGSHIP)))
    sd = model_state_dict(v["params"], v["batch_stats"])
    g = np.load(fixtures_dir / "solver_goldens.npz")
    return v, sd, (g["obs"][None], g["psf"][None], np.reshape(g["alpha"], (1,)))


def test_flagship_checkpoint_parity(flagship):
    v, sd, (obs, psf, alpha) = flagship
    assert sum(t.numel() for k, t in sd.items() if "running_" not in k and "num_batches" not in k) == 4_331_940

    jm = JModel(n_iters=8, features=(32, 64, 128, 256), fft_impl="xla")
    want = jax.jit(jm.apply)(v, jnp.asarray(obs), jnp.asarray(psf), jnp.asarray(alpha))
    want_shear = np.asarray(jestimate_shear(want))

    pipe = build_pipeline("cpu", state_dict=sd)
    got = pipe.reconstruct(obs, psf, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # shear at the tolerance tests/test_metrics.py holds the numpy twin to
    np.testing.assert_allclose(estimate_shear(got).numpy(), want_shear, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pipe(obs, psf, alpha).numpy(), want_shear, rtol=1e-4, atol=1e-5)


def test_flagship_checkpoint_bf16_parity(flagship):
    v, sd, (obs, psf, alpha) = flagship
    kw = dict(n_iters=8, features=(32, 64, 128, 256), analysis=True)
    jm = JModel(**kw, dtype=jnp.bfloat16, fft_impl="xla")
    want = jax.jit(jm.apply)(v, jnp.asarray(obs), jnp.asarray(psf), jnp.asarray(alpha))
    tm = UnrolledADMMGaussian(**kw, dtype=torch.bfloat16)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, (obs, psf, alpha)))
    assert_traces_close(got, want, BF16_REL)
    np.testing.assert_allclose(estimate_shear(got["z"][:, -1]).numpy(),
                               np.asarray(jestimate_shear(want["z"][:, -1])), rtol=0, atol=BF16_SHEAR_ATOL)
