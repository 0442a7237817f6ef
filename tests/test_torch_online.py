"""Port parity: online training (galaxy_deconv_tpu_torch.train.online), the
shared train step it runs, the stall watchdog, ``fit``'s watchdog and ``cli
train --online``, against the JAX package where it has a counterpart.

The samplers of the two packages cannot share random streams (``fold_in``
keys against ``torch.Generator`` seeds), so a step is held to JAX's
``_online_step_body`` on an injected sampler that returns JAX's own simulated
batch.  Narrow flagship: n_iters 2, features (8, 8, 16, 16), B = 4, the small
pupil of tests/test_data.py."""

import functools
import json
import re
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import simulate as J
from galaxy_deconv_tpu.losses import multiscale as jms
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu.train import online as jonline
from galaxy_deconv_tpu.train.state import TrainState as JTrainState
from galaxy_deconv_tpu.train.state import create_train_state as jcreate_train_state
from galaxy_deconv_tpu.train.state import default_optimizer as jdefault_optimizer
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import simulate as T
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.train import (
    TrainState,
    create_train_state,
    default_optimizer,
    fit,
    make_online_eval_step,
    make_online_train_scan,
    make_online_train_step,
)
from galaxy_deconv_tpu_torch.train import loop as tloop
from galaxy_deconv_tpu_torch.train import online as tonline
from galaxy_deconv_tpu_torch.train.checkpoint import load_payload, state_payload
from galaxy_deconv_tpu_torch.utils.convert_flax import train_state_payload
from galaxy_deconv_tpu_torch.utils.watchdog import STALL_EXIT_CODE, StallWatchdog
from test_torch_zoo import as_np, variables
from test_torch_zoo import jit as jit0

NARROW = dict(n_iters=2, features=(8, 8, 16, 16))
SMALL = dict(pupil_n=64, pupil_pad=128)
TINY = dict(pupil_n=16, pupil_pad=32)
LR = 2e-4
B = 4


def jax_payload(st):
    adam = st.opt_state[1][0]
    return train_state_payload(as_np(st.params), as_np(st.batch_stats), as_np(adam.mu), as_np(adam.nu), adam.count,
                               st.step)


def port_state(payload):
    model = UnrolledADMMGaussian(**NARROW)
    return load_payload(TrainState(0, model, default_optimizer().init(model)), payload)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's simulated batch (as numpy), a train state filled from numpy
    (``test_torch_zoo.variables``: an un-jitted ``init`` takes ~30 s), JAX's
    online step from it and its eval step after it, on a sampler that
    returns that batch (both compiled at XLA's backend level 0)."""
    cfg = J.SimulationConfig(**SMALL)
    batch = as_np(J.simulate_batch(jax.random.PRNGKey(7), B, cfg))
    batch["alpha"] = batch["obs"].mean(axis=(1, 2))
    model = JModel(**NARROW, fft_impl="xla")
    v, opt = variables(model, batch["obs"], batch["psf"], batch["alpha"]), jdefault_optimizer(LR)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                        opt_state=opt.init(v["params"]))
    sampler = lambda key, n, c: {k: jnp.asarray(v) for k, v in batch.items()}  # noqa: E731
    step = jit0(jonline._online_step_body(model, jms.MultiScaleLoss(), opt, B, cfg, sampler))
    new_state, loss = step(state, jax.random.PRNGKey(1))
    eval_step = jit0(jonline.make_online_eval_step(model, jms.MultiScaleLoss(), B, cfg, sampler=sampler).__wrapped__)
    eval_loss = float(eval_step(new_state, jax.random.PRNGKey(2)))
    return dict(batch=batch, before=jax_payload(state), after=jax_payload(new_state), loss=float(loss),
                eval_loss=eval_loss)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors: beside the tier-1
    run's other workers, OpenMP teams of 8 threads on 8 shared cores stall at
    every barrier (test_fused_steps_equal_single_steps took 187 s there,
    0.9 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def injected(batch):
    """A port sampler that returns ``batch`` whatever the seed (its own alpha
    is dropped: the step recomputes it, as JAX's does)."""
    return lambda seed, n, cfg, device="cpu": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
                                               if k != "alpha"}


def zero_grad_param(name):
    """The SubNet's conv biases feed train-mode BatchNorm: exact gradient 0,
    rounding noise on both sides, so Adam's first step moves them by +-lr."""
    return re.fullmatch(r"subnet\.convs\.\d+\.conv\d\.bias", name) is not None


# --- the online step against JAX ------------------------------------------------------------


def test_online_step_matches_jax(jax_side):
    # One step from the bridged state on JAX's own batch: the loss at 1e-5
    # (as the disk step in tests/test_torch_train.py).  Adam's first step is
    # lr c / (|c| + 1e-8) for the clipped gradient c = g / max(|g|_2, 1): where
    # |c| >= 1e-6 it is within 1 % of lr, so two such steps of one sign differ
    # by < 0.02 lr.  Those entries, when also >= 1e-2 of their tensor's
    # largest gradient (the disk step holds each gradient to 5e-4 of its
    # tensor's largest, so there to 5 % of the entry), are held within
    # 0.02 lr (reading 7.5e-5 lr; 11 % to 95 % of each tensor's entries); the
    # others move by up to lr either way and are held within 2 lr (readings up
    # to 1.996 lr, subnet.convs.3.conv1.weight: gradients of opposite sign at
    # 1e-8 of the tensor's largest); the SubNet's
    # zero-gradient conv biases only finite; the running statistics at 1e-5;
    # the step and Adam count 1.
    state = port_state(jax_side["before"])
    step = make_online_train_step(state.model, MultiScaleLoss(), default_optimizer(LR), B, T.SimulationConfig(**SMALL),
                                  sampler=injected(jax_side["batch"]))
    state, loss = step(state, 123)
    assert abs(float(loss) - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
    got, want = state_payload(state), jax_side["after"]
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    norm = max(float(torch.sqrt(sum((g * g).sum() for g in grads.values()))), 1.0)
    assert got["step"] == want["step"] == 1 and got["opt_state"]["count"] == want["opt_state"]["count"] == 1
    for name, w in want["model"].items():
        if "running_" in name:
            np.testing.assert_allclose(got["model"][name].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        elif "num_batches" in name:
            continue
        elif zero_grad_param(name):
            assert torch.isfinite(got["model"][name]).all(), name
        else:
            g = grads[name].abs()
            firm = (g >= 1e-6 * norm) & (g >= 1e-2 * g.max())
            diff = (got["model"][name] - w).abs()
            assert float(diff[firm].max()) <= 0.02 * LR and float(diff.max()) <= 2 * LR, name


def test_online_eval_step_matches_jax(jax_side):
    # eval-mode BatchNorm on the state after JAX's step, JAX's batch: 1e-5
    state = port_state(jax_side["after"])
    loss = make_online_eval_step(state.model, MultiScaleLoss(), B, T.SimulationConfig(**SMALL),
                                 sampler=injected(jax_side["batch"]))(state, 5)
    assert abs(float(loss) - jax_side["eval_loss"]) <= 1e-5 * abs(jax_side["eval_loss"])


# --- the skip, k fused steps ---------------------------------------------------------------


def poisoned_loss(gt, rec):
    """A finite value whose gradient is NaN (d sqrt(x) at 0), as JAX's
    TestFailureContainment poisons its step."""
    return torch.sqrt(rec * 0.0).sum()


@pytest.mark.parametrize("fault", ["nan_loss", "nan_grads"])
def test_online_step_skips_a_bad_update_whole(jax_side, fault):
    # parameters, BatchNorm statistics, Adam's moments and count bit for bit
    # unchanged; the step counted; the loss returned as it was
    batch = {k: np.array(v) for k, v in jax_side["batch"].items()}
    if fault == "nan_loss":
        batch["obs"][0, 0, 0] = np.nan
    state = port_state(jax_side["after"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = (int(state.opt_state.count), {k: v.clone() for k, v in state.opt_state.mu.items()},
                  {k: v.clone() for k, v in state.opt_state.nu.items()})
    loss_fn = MultiScaleLoss() if fault == "nan_loss" else poisoned_loss
    state, loss = make_online_train_step(state.model, loss_fn, default_optimizer(LR), B, T.SimulationConfig(**SMALL),
                                         sampler=injected(batch))(state, 0)
    assert np.isfinite(float(loss)) == (fault == "nan_grads")
    assert state.step == 2 and int(state.opt_state.count) == opt_before[0] == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for got, want in ((state.opt_state.mu, opt_before[1]), (state.opt_state.nu, opt_before[2])):
        for k, v in got.items():
            assert torch.equal(v, want[k]), k


def test_fused_steps_equal_single_steps():
    # 3 steps in one call against 3 calls of one step, from the same seed-0
    # weights on batches rendered from the same seeds: bit for bit on the CPU
    runs = []
    for fused in (True, False):
        model = UnrolledADMMGaussian(**NARROW)
        state, opt = create_train_state(model, 0)
        cfg, seeds = T.SimulationConfig(**TINY), [tonline.step_seed(0, tonline.TRAIN, i) for i in range(3)]
        if fused:
            state, losses = make_online_train_scan(model, MultiScaleLoss(), opt, 2, 3, cfg)(state, seeds)
        else:
            step = make_online_train_step(model, MultiScaleLoss(), opt, 2, cfg)
            losses = torch.stack([step(state, s)[1] for s in seeds])
        runs.append((losses, state_payload(state)))
    (la, a), (lb, b) = runs
    assert torch.equal(la, lb) and torch.isfinite(la).all() and a["step"] == b["step"] == 3
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 3
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for m in ("mu", "nu"):
        for k in a["opt_state"][m]:
            assert torch.equal(a["opt_state"][m][k], b["opt_state"][m][k]), (m, k)
    with pytest.raises(ValueError, match="2 seeds for a call of 3"):
        make_online_train_scan(model, MultiScaleLoss(), opt, 2, 3, cfg)(state, seeds[:2])


# --- fit_online against JAX's: cadences, validation batches, history --------------------------------------


class JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, obs, psf, alpha, train=False):
        return obs * self.param("w", fnn.initializers.ones, ())


class TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, obs, psf, alpha):
        return obs * self.w


def tiny_batch(obs):
    return {"obs": obs, "psf": obs * 0, "gt": obs * 0.5}


@pytest.mark.parametrize("n_steps,log,val,save,k", [(25, 10, 7, 12, 4), (20, 5, 10, 20, 10), (9, 0, 4, 0, 1),
                                                    (30, 100, 15, 30, 7)])
def test_fit_online_cadences_match_jax(tmp_path, monkeypatch, n_steps, log, val, save, k):
    """A one-weight model on 4 x 4 stamps, so that only the loop is compared:
    the steps taken, the validation steps, the checkpoints (best validation
    and every save_every), the history's keys and its file."""
    import galaxy_deconv_tpu.train.checkpoint as jckpt

    saved = {"jax": [], "port": []}
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda path, name, step, state: saved["jax"].append(step))
    monkeypatch.setattr(tonline, "save_checkpoint", lambda path, name, step, state: saved["port"].append(step))
    kw = dict(n_steps=n_steps, batch_size=2, log_every=log, val_every=val, val_batches=2, save_every=save,
              steps_per_call=k)
    (tmp_path / "jax").mkdir()  # the JAX loop writes its history there; its checkpoints are recorded instead
    jsampler = lambda key, n, cfg: tiny_batch(jax.random.normal(key, (n, 4, 4)))  # noqa: E731
    jstate, jopt = jcreate_train_state(JTiny(), jax.random.PRNGKey(0), {**tiny_batch(jnp.ones((2, 4, 4))),
                                                                        "alpha": jnp.ones(2)}, jdefault_optimizer(LR))
    jstate, jhist = jonline.fit_online(JTiny(), jstate, jopt, jms.mse_loss, sampler=jsampler, model_name="tiny",
                                       save_path=str(tmp_path / "jax"), **kw)

    def tsampler(seed, n, cfg, device="cpu"):
        return tiny_batch(torch.randn((n, 4, 4), generator=torch.Generator().manual_seed(seed % 2**63)))

    model = TTiny()
    state, opt = create_train_state(model, 0)
    state, hist = tonline.fit_online(model, state, opt, tloop_mse, sampler=tsampler, model_name="tiny",
                                     save_path=str(tmp_path / "port"), **kw)
    assert state.step == int(jstate.step)
    assert hist["step"] == jhist["step"] and saved["port"] == saved["jax"]
    assert hist.keys() == jhist.keys() == {"step", "train_loss", "val_loss", "best_step", "galaxies_per_sec"}
    assert len(hist["train_loss"]) == len(hist["val_loss"]) == len(hist["step"])
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    assert json.loads((tmp_path / "port" / "tiny_history.json").read_text()) == hist
    if hist["step"]:
        best = hist["step"][int(np.argmin(hist["val_loss"]))]
        assert hist["best_step"] == best and best in saved["port"]


def tloop_mse(gt, rec):
    return ((gt - rec) ** 2).mean()


def test_fit_online_validates_on_fixed_batches(tmp_path):
    # every validation renders the same seeds, none of them a training seed;
    # every training step renders a seed of its own
    seen = []

    def sampler(seed, n, cfg, device="cpu"):
        seen.append(seed)
        return tiny_batch(torch.randn((n, 4, 4), generator=torch.Generator().manual_seed(seed % 2**63)))

    model = TTiny()
    state, opt = create_train_state(model, 0)
    tonline.fit_online(model, state, opt, tloop_mse, n_steps=12, batch_size=2, val_every=4, val_batches=3,
                       sampler=sampler, steps_per_call=2, seed=3)
    train = [tonline.step_seed(3, tonline.TRAIN, i) for i in range(12)]
    val = [tonline.step_seed(3, tonline.VAL, j) for j in range(3)]
    assert seen == train[:4] + val + train[4:8] + val + train[8:] + val
    assert len(set(train + val)) == 15


# --- the watchdog ----------------------------------------------------------------------------


def test_watchdog_fires_once_after_timeout_without_beats():
    fired = []
    with StallWatchdog(timeout_s=0.2, name="t", poll_s=0.05, on_stall=lambda name, el: fired.append((name, el))):
        time.sleep(0.6)
    assert len(fired) == 1 and fired[0][0] == "t" and fired[0][1] > 0.2
    assert STALL_EXIT_CODE == 75


def test_watchdog_beats_keep_it_quiet_and_stop_joins():
    fired = []
    with StallWatchdog(timeout_s=0.3, poll_s=0.05, on_stall=lambda *a: fired.append(a)) as dog:
        for _ in range(10):
            time.sleep(0.05)
            dog.beat()
    assert fired == [] and dog._thread is None


def test_watchdog_disabled_when_timeout_none():
    with StallWatchdog(timeout_s=None) as dog:
        assert dog._thread is None
        dog.beat()


@pytest.mark.parametrize("timeout", [600.0, None])
def test_fit_arms_the_watchdog_and_beats(tmp_path, monkeypatch, timeout):
    """``fit`` takes ``stall_timeout_s`` (600 s by default, as the JAX
    package's): the watchdog gets it, is entered and left once, and beats
    after every step and every validation."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = cs.write_dataset(tmp_path / "data", n=12)
    events = []

    class Recorder(StallWatchdog):
        def __enter__(self):
            events.append(("enter", self.timeout_s, self.name))
            return self

        def __exit__(self, *exc):
            events.append(("exit",))

        def beat(self):
            events.append(("beat",))

    monkeypatch.setattr(tloop, "StallWatchdog", Recorder)
    model = UnrolledADMMGaussian(n_iters=1, features=(4, 4, 4, 4))
    state, opt = create_train_state(model, 0)
    kw = {} if timeout == 600.0 else {"stall_timeout_s": timeout}
    from galaxy_deconv_tpu_torch.data import GalaxyDataset

    state, hist = fit(model, state, opt, MultiScaleLoss(), GalaxyDataset(root), n_epochs=2, batch_size=4,
                      train_val_split=0.75, eval_every=2, model_name="m", **kw)
    # 9 training stamps: 2 steps an epoch, a mid-epoch validation after step 2, the epoch's validation
    assert events[0] == ("enter", timeout, "fit[m]") and events[-1] == ("exit",)
    assert events[1:-1] == [("beat",)] * (2 * (2 + 1 + 1))
    assert state.step == 4 and np.isfinite(hist["train_loss"]).all()


# --- the command line -------------------------------------------------------------------------


def test_cli_train_online_on_cpu(tmp_path, monkeypatch):
    # the command as a user gives it, with fit_online validating every 2 steps
    # over 1 batch and a 16-sample pupil, so that the CPU renders in seconds
    save = tmp_path / "models"
    monkeypatch.setattr(cli, "fit_online", functools.partial(tonline.fit_online, val_every=2, val_batches=1))
    monkeypatch.setattr(cli, "SimulationConfig", functools.partial(T.SimulationConfig, **TINY))
    state, hist = cli.main(["train", "--online", "--n_steps", "4", "--steps_per_call", "2", "--n_iters", "2",
                            "--batch_size", "2", "--model_save_path", str(save), "--seed", "0", "--device", "cpu"])
    name = "Gaussian_PnP_ADMM_2iters_MultiScale"
    assert state.step == 4 and hist["step"] == [2, 4] and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    assert json.loads((save / f"{name}_history.json").read_text()) == hist
    assert (save / f"{name}_{hist['best_step']}epochs" / "train_state.pt").is_file()
    assert next(state.model.parameters()).device.type == "cpu"
