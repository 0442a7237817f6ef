"""The trained flagship committed in the port's format, and the JAX package's
goldens beside it (``trained_port/``), against ``trained/`` and the JAX
package.

``trained_port/Gaussian_PnP_ADMM_8iters_MultiScale_7000epochs/train_state.pt``
is ``scripts/trained_to_port.py``'s output for the flagship and
``trained_port/flagship_goldens.npz`` ``scripts/flagship_goldens.py``'s:
the tests hold the first to the weight bridge's output bit for bit, the
second to a fresh JAX forward (1e-6 of the peak; the CPU reads 0), and the
port's CPU pipeline and ``cli test`` loaded from ``trained_port/`` to the
goldens at the full-model limits of tests/test_torch_model.py (rtol 1e-4,
atol 5e-4) and the harness's shear limit of tests/test_torch_eval.py
(|dg| <= 1e-5 (1 + |g|); the CPU reads 3e-6).
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from galaxy_deconv_tpu import cli as jcli
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data.generate_galsim import write_packed_dataset
from galaxy_deconv_tpu_torch.metrics import estimate_shear
from galaxy_deconv_tpu_torch.pipeline import build_pipeline
from galaxy_deconv_tpu_torch.train.checkpoint import best_epoch, restore_checkpoint, unpack_variables
from galaxy_deconv_tpu_torch.utils import model_state_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import flagship_goldens  # noqa: E402

TRAINED_PORT = REPO / "trained_port"
RUN, EPOCH = flagship_goldens.FLAGSHIP
RTOL, ATOL = 1e-4, 5e-4
SHEAR_TOL = 1e-5  # |g_port - g_jax| <= SHEAR_TOL * (1 + |g_jax|)
N_CHECK = 8  # of the goldens' 64 stamps, for CPU time
METHOD = "Unrolled_ADMM_Gaussian(8)"


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(TRAINED_PORT / "flagship_goldens.npz"))


@pytest.fixture(scope="module")
def variables():
    return flagship_goldens.load_flagship()


def assert_shears_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= SHEAR_TOL, f"max |g_port - g_jax| / (1 + |g_jax|) = {err:.3e} > {SHEAR_TOL}"


def test_committed_checkpoint_is_the_bridge_output_bit_for_bit(variables):
    payload = torch.load(TRAINED_PORT / f"{RUN}_{EPOCH}epochs" / "train_state.pt", map_location="cpu",
                         weights_only=True)
    assert payload["step"] == 0 and payload["opt_state"] == {"count": 0, "mu": {}, "nu": {}}
    want = model_state_dict(variables["params"], variables["batch_stats"])
    got = payload["model"]
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k].view(torch.uint8) if got[k].dtype.is_floating_point else got[k],
                           want[k].view(torch.uint8) if want[k].dtype.is_floating_point else want[k]), k
    assert sum(t.numel() for k, t in got.items() if "running_" not in k and "num_batches" not in k) == 4_331_940
    assert best_epoch(TRAINED_PORT, RUN) == EPOCH


def test_goldens_inputs(goldens, fixtures_dir):
    fixture = np.load(fixtures_dir / "solver_goldens.npz")
    for k in ("obs", "psf", "gt"):
        assert goldens[k].shape == (64, 48, 48) and goldens[k].dtype == np.float32
        np.testing.assert_array_equal(goldens[k][0], fixture[k])
    np.testing.assert_array_equal(goldens["alpha"], goldens["obs"].mean(axis=(1, 2)).astype(np.float32))
    np.testing.assert_allclose(goldens["psf"].sum(axis=(1, 2)), 1 / 16, rtol=1e-4)
    assert int(goldens["seed"]) == flagship_goldens.SEED and str(goldens["checkpoint"]) == f"{RUN}_{EPOCH}epochs"
    for k in ("rec", "rec_bf16"):
        assert goldens[k].shape == (64, 48, 48) and np.isfinite(goldens[k]).all()
    assert goldens["shear"].shape == goldens["shear_bf16"].shape == (64, 3)


@pytest.mark.parametrize("dtype,rec_key,shear_key", [("float32", "rec", "shear"),
                                                     ("bfloat16", "rec_bf16", "shear_bf16")])
def test_goldens_equal_a_fresh_jax_forward(goldens, variables, dtype, rec_key, shear_key):
    obs, psf, alpha = (goldens[k][:4] for k in ("obs", "psf", "alpha"))
    rec, shear = flagship_goldens.jax_forward(variables, obs, psf, alpha, dtype)
    scale = np.abs(goldens[rec_key][:4]).max()
    assert np.abs(rec - goldens[rec_key][:4]).max() <= 1e-6 * scale
    np.testing.assert_allclose(shear, goldens[shear_key][:4], rtol=0, atol=1e-6)


def test_port_pipeline_from_trained_port_holds_the_goldens(goldens):
    sd = unpack_variables(restore_checkpoint(TRAINED_PORT, RUN, best_epoch(TRAINED_PORT, RUN)))
    pipe = build_pipeline("cpu", state_dict=sd)
    obs, psf, alpha = (goldens[k][:N_CHECK] for k in ("obs", "psf", "alpha"))
    rec = pipe.reconstruct(obs, psf, alpha)
    np.testing.assert_allclose(rec.numpy(), goldens["rec"][:N_CHECK], rtol=RTOL, atol=ATOL)
    assert_shears_close(estimate_shear(rec).numpy(), goldens["shear"][:N_CHECK])
    assert_shears_close(pipe(obs, psf, alpha).numpy(), goldens["shear"][:N_CHECK])


@pytest.fixture(scope="module")
def cosmos_tree(goldens, tmp_path_factory):
    """The first 4 golden stamps as a COSMOS-layout tree, one variant obs_20."""
    stamps = {k: list(goldens[k][:4]) for k in ("obs", "psf", "gt")}
    meta = dict(n_train=4, n_test=4, fov_pixels=48, pixel_scale=0.2, upsample=4, seed=int(goldens["seed"]),
                snrs=[20], shear_errs=[], fwhm_errs=[], generator="galsim/COSMOS")
    return write_packed_dataset(tmp_path_factory.mktemp("cosmos"), {"train": stamps, "test": stamps},
                                {"obs_20": stamps["obs"], "gt_20": stamps["gt"]}, {}, meta)


def test_cli_test_loads_trained_port(goldens, cosmos_tree, tmp_path):
    got = cli.main(["test", "--test", "shear", "--methods", METHOD, "--model_save_path", str(TRAINED_PORT),
                    "--checkpoint_name", RUN, "--data_path", str(cosmos_tree), "--result_path", str(tmp_path),
                    "--n_gal", "4", "--eval_batch_size", "4", "--snrs", "20", "--device", "cpu"])
    assert_shears_close(got[METHOD]["20"]["rec_shear"], goldens["shear"][:4])


def test_cli_test_with_a_missing_checkpoint_fails(cosmos_tree, tmp_path):
    """No seed weights in place of a checkpoint that is not there; the JAX
    package's cli fails the same way (orbax finds no directory)."""
    common = ["test", "--test", "shear", "--methods", METHOD, "--model_save_path", str(TRAINED_PORT),
              "--checkpoint_name", "No_Such_Run", "--data_path", str(cosmos_tree), "--n_gal", "4",
              "--eval_batch_size", "4", "--snrs", "20"]
    with pytest.raises(FileNotFoundError, match="no checkpoint of No_Such_Run"):
        cli.main([*common, "--result_path", str(tmp_path / "port"), "--device", "cpu"])
    assert not (tmp_path / "port").exists()
    with pytest.raises(FileNotFoundError):
        jcli.main([*common, "--result_path", str(tmp_path / "jax"), "--n_devices", "1"])

