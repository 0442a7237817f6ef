"""Port parity: the device-resident trainer
(galaxy_deconv_tpu_torch.train.device_resident) against the JAX package's on
a packed tree of 24 stamps (``chip_smoke.write_dataset``), narrow flagship
(n_iters 2, features (8, 8, 16, 16)), B = 4: the same minibatch order, the
same history; the bad step; k fused steps against k single ones."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import dataset as jdataset
from galaxy_deconv_tpu.losses import multiscale as jms
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu.train import device_resident as jdr
from galaxy_deconv_tpu.train.state import TrainState as JTrainState
from galaxy_deconv_tpu.train.state import default_optimizer as jdefault_optimizer
from galaxy_deconv_tpu_torch.data import GalaxyDataset, train_val_indices
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.train import (
    TrainState,
    create_train_state,
    default_optimizer,
    fit_device_resident,
    make_indexed_multi_step,
    make_indexed_train_step,
    upload_split,
)
from galaxy_deconv_tpu_torch.train.checkpoint import load_payload, state_payload
from galaxy_deconv_tpu_torch.utils.convert_flax import train_state_payload
from test_torch_online import one_thread  # noqa: F401  (autouse: one torch thread here too)
from test_torch_zoo import as_np, variables
from test_torch_zoo import jit as jit0

REPO = pathlib.Path(__file__).resolve().parent.parent
NARROW = dict(n_iters=2, features=(8, 8, 16, 16))
LR = 2e-4


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.write_dataset(tmp_path_factory.mktemp("resident") / "data", n=24, seed=4)


class _JaxLevel0:
    """The ``jax`` module as JAX's device_resident sees it, but its ``jit``
    compiled at XLA's backend optimisation level 0 (half the compile time of
    the whole train step; the limits below were read at it)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, donate_argnums=()):
        return jit0(fn)


def test_upload_split_matches_jax(packed):
    # the same arrays, bit for bit; alpha computed on the host as JAX does
    got = upload_split(GalaxyDataset(packed), limit=20, device="cpu")
    want = jdr.upload_split(jdataset.GalaxyDataset(packed), limit=20)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape[0] == 20
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_fit_device_resident_matches_jax(packed, tmp_path, monkeypatch):
    """Two epochs from the same numpy-filled weights: the per-epoch train and
    validation losses at 5e-4 (readings: train 9.3e-7 and 6.2e-6, validation
    1.9e-5 and 8.8e-5; Adam's first steps move a parameter whose gradient is
    rounding noise by up to a learning rate either way, see
    tests/test_torch_online.py, and the eval-mode loss after 8 steps carries
    that), the checkpoints (a new best and every 5 epochs) at the same
    epochs, 8 steps."""
    ds, jds = GalaxyDataset(packed), jdataset.GalaxyDataset(packed)
    b = jds.batch(np.arange(4))
    model = JModel(**NARROW, fft_impl="xla")
    v, opt = variables(model, b["obs"], b["psf"], b["alpha"], seed=1), jdefault_optimizer(LR)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                         opt_state=opt.init(v["params"]))
    adam = jstate.opt_state[1][0]
    payload = train_state_payload(as_np(jstate.params), as_np(jstate.batch_stats), as_np(adam.mu), as_np(adam.nu),
                                  adam.count, jstate.step)
    tmodel = UnrolledADMMGaussian(**NARROW)
    tstate = load_payload(TrainState(0, tmodel, default_optimizer(LR).init(tmodel)), payload)

    saved = {"jax": [], "port": []}
    import galaxy_deconv_tpu.train.checkpoint as jckpt
    from galaxy_deconv_tpu_torch.train import device_resident as tdr

    monkeypatch.setattr(jckpt, "save_checkpoint", lambda p, n, epoch, st: saved["jax"].append(epoch))
    monkeypatch.setattr(tdr, "save_checkpoint", lambda p, n, epoch, st: saved["port"].append(epoch))
    monkeypatch.setattr(jdr, "jax", _JaxLevel0())
    kw = dict(n_epochs=2, batch_size=4, train_val_split=0.8, seed=3, save_path=str(tmp_path))
    jstate, jhist = jdr.fit_device_resident(model, jstate, opt, jms.MultiScaleLoss(), jds, **kw)
    tstate, thist = fit_device_resident(tmodel, tstate, default_optimizer(LR), MultiScaleLoss(), ds, **kw)
    assert thist.keys() == jhist.keys() == {"train_loss", "val_loss", "epoch_time"}
    assert tstate.step == int(jstate.step) == 2 * (len(train_val_indices(24, 0.8, 3)[0]) // 4)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=5e-4, err_msg=k)
    assert saved["port"] == saved["jax"] and saved["port"][0] == 1


def poisoned_loss(gt, rec):
    """A finite value whose gradient is NaN (d sqrt(x) at 0), as JAX's
    TestDeviceResident poisons its step."""
    return torch.sqrt(rec * 0.0).sum()


def test_bad_indexed_step_reverts_the_opt_state_too(packed):
    # parameters, BatchNorm statistics and Adam's moments and count bit for bit
    # after a NaN-gradient step; the loss finite, the step counted
    model = UnrolledADMMGaussian(**NARROW)
    state, opt = create_train_state(model, 0)
    data = upload_split(GalaxyDataset(packed), device="cpu")
    state, _ = make_indexed_train_step(model, MultiScaleLoss(), opt, data)(state, torch.arange(4))
    before = {k: v.clone() for k, v in state_payload(state)["model"].items()}
    mu, nu = ({k: v.clone() for k, v in d.items()} for d in (state.opt_state.mu, state.opt_state.nu))
    count = int(state.opt_state.count)
    state, loss = make_indexed_train_step(model, poisoned_loss, opt, data)(state, torch.arange(4, 8))
    assert np.isfinite(float(loss)) and state.step == 2 and int(state.opt_state.count) == count == 1
    for k, v in state_payload(state)["model"].items():
        assert torch.equal(v, before[k]), k
    for got, want in ((state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_k_indexed_steps_equal_k_single_steps(packed):
    # bit for bit on the CPU: 3 steps in one call against 3 calls, the mean of
    # the 3 losses against theirs
    data = upload_split(GalaxyDataset(packed), device="cpu")
    idxs = torch.as_tensor(np.random.default_rng(0).permutation(24)[:12].reshape(3, 4))
    runs = []
    for fused in (True, False):
        model = UnrolledADMMGaussian(**NARROW)
        state, opt = create_train_state(model, 0)
        if fused:
            state, loss = make_indexed_multi_step(model, MultiScaleLoss(), opt, data)(state, idxs)
        else:
            step = make_indexed_train_step(model, MultiScaleLoss(), opt, data)
            loss = torch.stack([step(state, i)[1] for i in idxs]).mean()
        runs.append((loss, state_payload(state)))
    (la, a), (lb, b) = runs
    assert torch.equal(la, lb) and a["step"] == b["step"] == 3 and a["opt_state"]["count"] == 3
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for m in ("mu", "nu"):
        for k in a["opt_state"][m]:
            assert torch.equal(a["opt_state"][m][k], b["opt_state"][m][k]), (m, k)
