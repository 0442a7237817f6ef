"""Port parity: the zoo's trained checkpoints in trained/, carried across by
the bridge (utils/convert_flax.py) and held against the JAX forward on the
same stamps: the reference's golden stamp and three simulated ones (the
port's simulator, small pupil; the denoiser on denoising-task stamps).  Full
width: the Poisson Unrolled_ADMM(8) (ResUNet(64, 128, 256, 512) +
SubNet(16)), Tikhonet_Laplacian and ShapeNet (XDenseUNet), the ResUNet
denoiser alone and frozen inside ADMMNet(8).  Tolerance: the full-model rtol
1e-4, atol 5e-4 of tests/test_torch_model.py on outputs divided by alpha
where the model multiplies by it (the Poisson ADMM per stamp relative to its
peak, see POISSON_PEAK_REL); shears through the harness at
tests/test_torch_eval.py's 1e-5 (1 + |g|)."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.eval import harness as jharness
from galaxy_deconv_tpu.models import registry as jregistry
from galaxy_deconv_tpu.train.checkpoint import restore_checkpoint, unpack_variables
from galaxy_deconv_tpu_torch.data import generate_dataset
from galaxy_deconv_tpu_torch.data import simulate as T
from galaxy_deconv_tpu_torch.eval import harness as tharness
from galaxy_deconv_tpu_torch.models import build_model
from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict
from test_torch_zoo import jit

TRAINED = pathlib.Path(__file__).resolve().parent.parent / "trained"
RTOL, ATOL = 1e-4, 5e-4
SHEAR_TOL = 1e-5
SMALL_SIM = dict(pupil_n=64, pupil_pad=128)


def trained(name: str, epoch: int) -> dict:
    return jax.tree.map(np.asarray, unpack_variables(restore_checkpoint(TRAINED, name, epoch)))


def n_values(tree) -> int:
    return sum(np.size(a) for a in jax.tree.leaves(tree))


@pytest.fixture(scope="module")
def stamps(fixtures_dir):
    g = np.load(fixtures_dir / "solver_goldens.npz")
    b = T.simulate_batch(17, 3, T.SimulationConfig(**SMALL_SIM), "cpu")
    obs = np.concatenate([g["obs"][None], b["obs"].numpy()])
    psf = np.concatenate([g["psf"][None], b["psf"].numpy()])
    return obs, psf, obs.mean(axis=(1, 2))


@pytest.fixture(scope="module")
def denoise_stamps():
    b = T.simulate_batch_denoise(18, 3, T.SimulationConfig(**SMALL_SIM), "cpu")
    return b["obs"].numpy(), b["psf"].numpy(), b["obs"].numpy().mean(axis=(1, 2))


def both(name: str, variables: dict, inputs, **kw):
    """The JAX model and the port's of harness name ``name`` with the same
    weights, each on ``inputs``: (port, JAX) outputs."""
    jm = jregistry.build_model(name, **kw)
    want = np.asarray(jit(jm.apply)(variables, *inputs))
    tm = build_model(name, **kw)
    tm.load_state_dict(model_state_dict(variables["params"], variables.get("batch_stats")))
    with torch.no_grad():
        got = tm.eval()(*map(torch.from_numpy, inputs)).numpy()
    return got, want


def assert_model_close(got, want, alpha=None):
    if alpha is not None:
        got, want = got / alpha[:, None, None], want / alpha[:, None, None]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# The trained Poisson ADMM's outputs peak at 2.4e8-3.9e8 x alpha on these
# stamps: the reference's wrong Poisson root (models/unrolled_admm.py) lets
# the loop grow a spike, and float32's spacing there is >= 16, so no absolute
# tolerance can hold.  It is held per stamp to max |port - JAX| <= 1e-4 of
# max |JAX| (chip_smoke.py's card-against-CPU norm).  Readings: 2.6e-6 to
# 9.2e-6 against JAX compiled as test_torch_zoo.jit compiles it, 1.4e-6 to
# 1.1e-5 against its default compile (the two compiles differ by 3.0e-6 to
# 1.1e-5); JAX's own output moves by 1.7e-6 to 3.6e-6 of its peak when obs
# moves by one ulp.
POISSON_PEAK_REL = 1e-4


def test_poisson_unrolled_admm_checkpoint(stamps):
    v = trained("Poisson_PnP_ADMM_8iters_MultiScale", 10000)
    assert n_values(v) == 17_088_156
    # + 8: the SubNet's num_batches_tracked, which flax does not keep
    assert sum(t.numel() for t in model_state_dict(v["params"], v["batch_stats"]).values()) == 17_088_156 + 8
    got, want = both("Unrolled_ADMM(8)", v, stamps)
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert rel.max() <= POISSON_PEAK_REL, rel


@pytest.mark.parametrize("name,method,epoch", [("Tikhonet_Laplacian_MultiScale", "Tikhonet_Laplacian", 5000),
                                               ("ShapeNet_Laplacian", "ShapeNet", 4000)])
def test_tikhonet_checkpoints(stamps, name, method, epoch):
    v = trained(name, epoch)
    assert n_values(v) == 415_706 and n_values(v["params"]["XDenseUNet_0"]) == 397_113
    got, want = both(method, v, stamps)
    assert_model_close(got, want, stamps[2])


@pytest.fixture(scope="module")
def denoiser():
    v = trained("ResUNet_MultiScale", 4000)
    assert n_values(v) == 17_007_744 and list(v["params"]) == ["ResUNet_0"]
    return v


def test_resunet_denoiser_checkpoint(denoiser, denoise_stamps):
    got, want = both("ResUNet", denoiser, denoise_stamps)
    assert_model_close(got, want)


def test_admmnet_with_the_trained_denoiser(denoiser, stamps):
    """ADMMNet(8) is assembled from the ResUNet checkpoint's ResUNet_0, as the
    JAX package's scripts/run_benchmark.py does; the port's ADMMNet loads the
    ResUNet denoiser's state_dict as it is."""
    got, want = both("ADMMNet(8)", {"params": {"ResUNet_0": denoiser["params"]["ResUNet_0"]}}, stamps)
    assert_model_close(got, want, stamps[2])
    port = build_model("ADMMNet(8)")
    port.load_state_dict(model_state_dict(denoiser["params"]))  # the denoiser's own keys


def test_harness_runs_trained_tikhonet_as_jax(tmp_path):
    """eval/harness.py needs nothing beyond build_model for the zoo: the shear
    sweep of the trained Tikhonet_Laplacian gives JAX's harness's shears on
    the same tree (a ragged final batch included)."""
    root = generate_dataset(tmp_path / "ds", n_train=2, n_test=5, cfg=T.SimulationConfig(**SMALL_SIM), chunk=5,
                            snrs=(20, 100), shear_errs=(0.02,), fwhm_errs=(0.05,), verbose=False, device="cpu")
    v = trained("Tikhonet_Laplacian_MultiScale", 5000)
    kw = dict(snrs=(20, 100), n_gal=5, batch_size=4)
    want = jharness.run_shear_test("Tikhonet_Laplacian", root, tmp_path / "jax", variables=v, **kw)
    got = tharness.run_shear_test("Tikhonet_Laplacian", root, tmp_path / "port", device="cpu",
                                  state_dict=model_state_dict(v["params"], v["batch_stats"]), **kw)
    for snr in ("20", "100"):
        g, w = np.asarray(got[snr]["rec_shear"]), np.asarray(want[snr]["rec_shear"])
        assert g.shape == w.shape == (5, 3) and np.isfinite(g).all()
        err = (np.abs(g - w) / (1 + np.abs(w))).max()
        assert err <= SHEAR_TOL, f"snr {snr}: {err:.3e}"
