"""Port parity: the training slice of galaxy_deconv_tpu_torch against the JAX
package on the same numpy inputs, at narrow width (n_iters 2, features
(8, 8, 16, 16), B = 4): average_downsample, the losses, train-mode BatchNorm,
the clipped Adam, whole train steps through the bridged train state, the
skipped step, the dataset readers, checkpoints and ``cli train``.  Each test
states its tolerance and why."""

import copy
import importlib.util
import json
import pathlib
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.data import dataset as jdataset
from galaxy_deconv_tpu.losses import multiscale as jms
from galaxy_deconv_tpu.losses import naming as jnaming
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu.ops.resize import average_downsample as javg
from galaxy_deconv_tpu.train import checkpoint as jckpt
from galaxy_deconv_tpu.train.loop import make_train_step as jmake_train_step
from galaxy_deconv_tpu.train.state import create_train_state as jcreate_train_state
from galaxy_deconv_tpu.train.state import default_optimizer as jdefault_optimizer
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import GalaxyDataset, iterate_batches, train_val_indices
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss, build_loss, get_model_name, l1_loss, mse_loss
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.nets import BatchNorm2d
from galaxy_deconv_tpu_torch.ops.resize import average_downsample
from galaxy_deconv_tpu_torch.train import (
    ClippedAdam,
    TrainState,
    best_epoch,
    create_train_state,
    default_optimizer,
    latest_epoch,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    unpack_variables,
)
from galaxy_deconv_tpu_torch.train.checkpoint import load_payload, state_payload
from galaxy_deconv_tpu_torch.utils.convert_flax import train_state_payload

REPO = pathlib.Path(__file__).resolve().parent.parent
NARROW = dict(n_iters=2, features=(8, 8, 16, 16))
LR = 2e-4


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_np(tree):
    return jax.tree.map(np.array, tree)


def to_torch_layout(tree):
    """A JAX parameter-shaped tree (params, grads, moments) -> port names and layouts."""
    return train_state_payload(as_np(tree), None, as_np(tree), as_np(tree), 0, 0)["opt_state"]["mu"]


def zero_grad_param(name):
    """The SubNet's conv biases feed train-mode BatchNorm, which subtracts
    their effect: their exact gradient is 0 and both frameworks hold rounding
    noise there (~1e-5 of the largest gradient)."""
    return re.fullmatch(r"subnet\.convs\.\d+\.conv\d\.bias", name) is not None


@pytest.fixture
def rng():
    return np.random.default_rng(29)


# --- resize and losses -------------------------------------------------------


@pytest.mark.parametrize("rate", [1, 2, 4])
def test_average_downsample_matches_jax(rng, rate):
    x = rng.standard_normal((3, 48, 48)).astype(np.float32)
    np.testing.assert_allclose(average_downsample(torch.from_numpy(x), rate).numpy(), np.asarray(javg(x, rate)),
                               rtol=1e-6, atol=1e-6)


def test_average_downsample_rejects_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        average_downsample(torch.zeros(1, 10, 12), 4)


def loss_pair(rng, fn_t, fn_j, B=4):
    """Value and gradients w.r.t. both arguments, port and JAX, on one input."""
    gt = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * rng.uniform(0.1, 10, (B, 1, 1)).astype(np.float32)
    rec = gt + rng.standard_normal((B, 48, 48)).astype(np.float32)
    a, b = torch.from_numpy(gt).requires_grad_(), torch.from_numpy(rec).requires_grad_()
    val = fn_t(a, b)
    val.backward()
    val = val.detach()
    jval, jgrads = jax.value_and_grad(fn_j, argnums=(0, 1))(jnp.asarray(gt), jnp.asarray(rec))
    return (float(val), a.grad.numpy(), b.grad.numpy()), (float(jval), *map(np.asarray, jgrads))


@pytest.mark.parametrize("norm", ["L1", "L2"])
@pytest.mark.parametrize("flux_normalize", [False, True])
def test_multiscale_loss_matches_jax(rng, norm, flux_normalize):
    # values at rtol 3e-6 (float32 means over 9,216 pixels summed in another
    # order; readings 1.0e-7 to 5.4e-7), input gradients at rtol 1e-5 /
    # atol 1e-9 (they are ~1e-4 per pixel; readings within 5.7e-7 of the max)
    kw = dict(norm=norm, flux_normalize=flux_normalize)
    got, want = loss_pair(rng, MultiScaleLoss(**kw), jms.MultiScaleLoss(**kw))
    np.testing.assert_allclose(got[0], want[0], rtol=3e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("name", ["mse", "l1"])
def test_pixel_losses_match_jax(rng, name):
    fns = {"mse": (mse_loss, jms.mse_loss), "l1": (l1_loss, jms.l1_loss)}[name]
    got, want = loss_pair(rng, *fns)
    np.testing.assert_allclose(got[0], want[0], rtol=3e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("method,loss,kw", [
    ("Unrolled_ADMM", "MultiScale", {}),
    ("Unrolled_ADMM", "MSE", {"n_iters": 4, "remove_subnet": True}),
    ("Unrolled_ADMM", "MultiScale", {"llh": "Poisson", "pnp": False}),
    ("Tikhonet", "MSE", {"filter": "Identity"}),
    ("ShapeNet", "Shape", {}),
    ("ResUNet", "MultiScale", {}),
])
def test_model_names_match_jax(method, loss, kw):
    assert get_model_name(method, loss, **kw) == jnaming.get_model_name(method, loss, **kw)


def test_build_loss():
    assert build_loss("MultiScale") == MultiScaleLoss()
    assert build_loss("MultiScale", norm="L2").norm == "L2"
    assert build_loss("MSE") is mse_loss
    for name in ("Shape", "BestEllipse", "MomentBasedLoss"):
        with pytest.raises(ValueError, match="item 13"):
            build_loss(name)
    with pytest.raises(ValueError, match="unknown loss"):
        build_loss("Huber")


# --- BatchNorm in train mode ---------------------------------------------------


def test_batchnorm_train_mode_matches_flax(rng):
    # Three train-mode calls: outputs and running statistics against flax's
    # BatchNorm(momentum=0.9) at 1e-5.  torch's own BatchNorm2d stores the
    # unbiased variance; the same check reads it 1e-3 to 1e-2 off (asserted
    # below, so the test can see the fault it guards against).
    C = 3
    xs = [rng.standard_normal((4, 8, 8, C)).astype(np.float32) * 2 + 1 for _ in range(3)]
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = mod.init(jax.random.PRNGKey(0), xs[0])["batch_stats"]
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, C).astype(np.float32)),
              "bias": jnp.asarray(rng.standard_normal(C).astype(np.float32))}
    ours, native = BatchNorm2d(C, eps=1e-5, momentum=0.1).train(), torch.nn.BatchNorm2d(C, momentum=0.1).train()
    with torch.no_grad():
        for bn in (ours, native):
            bn.weight.copy_(torch.from_numpy(np.array(params["scale"])))
            bn.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    for x in xs:
        want, upd = mod.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
        np.testing.assert_allclose(ours(xt).detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=1e-5)
        native(xt)
    for key, torch_key in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(ours, torch_key).numpy(), np.asarray(stats[key]), rtol=1e-5, atol=1e-5)
    var = np.asarray(stats["var"])
    assert np.abs(native.running_var.numpy() - var).max() / np.abs(var).max() > 1e-3


def test_batchnorm_train_mode_gradient_matches_flax(rng):
    # input, scale and bias gradients of sum(w * BN(x)) at 1e-5
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = mod.init(jax.random.PRNGKey(0), x)

    def f(p, xx):
        return jnp.sum(w * mod.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, mutable=["batch_stats"])[0])

    gp, gx = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x))
    bn = BatchNorm2d(3).train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    (bn(xt) * torch.from_numpy(w.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5, atol=1e-5)


# --- train steps against JAX ---------------------------------------------------


def make_batch(rng, B=4, nan=False):
    gt = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 5
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    obs = gt + rng.standard_normal((B, 48, 48)).astype(np.float32)
    if nan:
        obs[0, 0, 0] = np.nan
    return dict(obs=obs, psf=psf, gt=gt, alpha=obs.mean(axis=(1, 2)))


def jax_state_payload(st):
    adam = st.opt_state[1][0]
    return train_state_payload(as_np(st.params), as_np(st.batch_stats), as_np(adam.mu), as_np(adam.nu),
                               adam.count, st.step)


def port_state_from(payload):
    model = UnrolledADMMGaussian(**NARROW)
    state = TrainState(0, model, default_optimizer().init(model))
    return load_payload(state, payload)


class JaxRun:
    """The JAX model, its train state, its jitted step, and its jitted loss gradient."""

    def __init__(self, batch):
        self.model = JModel(**NARROW, fft_impl="xla")
        self.state, self.optimizer = jcreate_train_state(
            self.model, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}, jdefault_optimizer())
        self.step = jmake_train_step(self.model, jms.MultiScaleLoss(), self.optimizer, donate=False)

        def loss_of(params, stats, batch):
            rec, _ = self.model.apply({"params": params, "batch_stats": stats}, batch["obs"], batch["psf"],
                                      batch["alpha"], True, mutable=["batch_stats"])
            return jms.MultiScaleLoss()(batch["gt"], rec)

        self._grads = jax.jit(jax.grad(loss_of))

    def grads(self, batch):
        return self._grads(self.state.params, self.state.batch_stats, batch)


@pytest.fixture(scope="module")
def three_steps():
    """Three train steps on one batch by each side from the same bridged state;
    per step: JAX's loss, gradients and state, and the port's."""
    batch = make_batch(np.random.default_rng(41))
    jr = JaxRun(batch)
    tstate = port_state_from(jax_state_payload(jr.state))
    tstep = make_train_step(tstate.model, MultiScaleLoss(), default_optimizer())
    steps = []
    for _ in range(3):
        jtree = jr.grads(batch)
        jgrads = to_torch_layout(jtree)
        jr.state, jloss = jr.step(jr.state, batch)
        tstate, tloss = tstep(tstate, batch)
        steps.append(dict(jloss=float(jloss), tloss=float(tloss), jtree=jtree, jgrads=jgrads,
                          tgrads={n: p.grad.clone() for n, p in tstate.model.named_parameters()},
                          jstate=jax_state_payload(jr.state), tstate=copy.deepcopy(state_payload(tstate))))
    return batch, jr, steps


def test_train_step_loss_and_gradients_match_jax(three_steps):
    # Step 1 from the bridged initial state.  Loss at 1e-5 (reading 3.7e-7).
    # Gradients: each parameter's to 5e-4 of its own largest entry (reading
    # 6.6e-5, subnet.convs.0.bn0.weight: 2 unrolled iterations of convolutions
    # summed in another order).  The SubNet conv biases, whose exact gradient
    # is 0, to 1e-4 of the model's largest gradient on both sides (readings:
    # JAX 3.8e-6, the port 7.1e-6).
    _, _, steps = three_steps
    s = steps[0]
    assert abs(s["tloss"] - s["jloss"]) <= 1e-5 * abs(s["jloss"])
    top = max(float(g.abs().max()) for g in s["jgrads"].values())
    for name, want in s["jgrads"].items():
        got = s["tgrads"][name]
        if zero_grad_param(name):
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-4 * top, name
        else:
            assert float((got - want).abs().max()) <= 5e-4 * float(want.abs().max()), name


def test_train_step_batch_stats_match_jax(three_steps):
    # the running statistics after one step: 0.9 * init + 0.1 * batch stats,
    # at 1e-5 (reading 8.3e-7)
    _, _, steps = three_steps
    got, want = steps[0]["tstate"]["model"], steps[0]["jstate"]["model"]
    for name in want:
        if "running_" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_params_after_three_steps_match_jax(three_steps):
    # After 3 whole steps, in units of the learning rate.  Adam's first step is
    # ~lr * sign(g), so a parameter moves by a whole lr step either way where
    # |g| is rounding noise: the SubNet conv biases (exact gradient 0) are
    # ill-conditioned (reading 4.2 lr apart) and only checked finite.  Every
    # other parameter to 0.02 lr (reading 2.0e-3 lr,
    # resunet.resblocks.7.conv1.weight).
    _, _, steps = three_steps
    got, want = steps[-1]["tstate"]["model"], steps[-1]["jstate"]["model"]
    for name, w in want.items():
        if "running_" in name or "num_batches" in name:
            continue
        if zero_grad_param(name):
            assert torch.isfinite(got[name]).all(), name
        else:
            assert float((got[name] - w).abs().max()) <= 0.02 * LR, name
    assert steps[-1]["tstate"]["step"] == 3 and steps[-1]["tstate"]["opt_state"]["count"] == 3


def test_step_from_bridged_trained_state_matches_jax(three_steps):
    # One more step from JAX's state after three steps (non-zero Adam moments
    # carried across by the bridge, the transposed convolutions' flips
    # included): updated parameters at 5e-3 lr (reading 4.3e-4 lr), moments at
    # 1e-4 of each tensor's largest entry (reading 2.4e-6); the SubNet conv
    # biases are left out, as above.
    batch, jr, steps = three_steps
    state = port_state_from(steps[-1]["jstate"])
    state, _ = make_train_step(state.model, MultiScaleLoss(), default_optimizer())(state, batch)
    jstate, _ = jr.step(jr.state, batch)
    want, got = jax_state_payload(jstate), state_payload(state)
    for name, w in want["model"].items():
        if "running_" in name or "num_batches" in name or zero_grad_param(name):
            continue
        assert float((got["model"][name] - w).abs().max()) <= 5e-3 * LR, name
    for m in ("mu", "nu"):
        for name, w in want["opt_state"][m].items():
            if not zero_grad_param(name):
                assert float((got["opt_state"][m][name] - w).abs().max()) <= 1e-4 * float(w.abs().max()), (m, name)
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 4


@pytest.mark.parametrize("kw", [{}, {"clip_norm": 1e6}, {"schedule": "cosine", "total_steps": 2}],
                         ids=["clipped", "unclipped", "cosine"])
def test_optimizer_matches_optax(three_steps, kw):
    # The optimizer alone, fed JAX's first-step gradients three times (scaled
    # 1, -0.5 and 2), against optax's chain(clip_by_global_norm, adam): updates
    # to 1e-6 of the learning rate (reading 2.2e-7), moments at rtol 1e-6
    # (reading 1.6e-7).
    import optax

    from galaxy_deconv_tpu.train.state import default_optimizer as jopt

    _, jr, steps = three_steps
    jgrads, tgrads = steps[0]["jtree"], steps[0]["jgrads"]
    opt_j = jopt(LR, **kw)
    st_j = opt_j.init(jr.state.params)
    update_j = jax.jit(opt_j.update)
    opt_t = ClippedAdam(lr=LR, **kw)
    st_t = opt_t.init(port_state_from(steps[0]["jstate"]).model)
    for scale in (1.0, -0.5, 2.0):
        uj, st_j = update_j(jax.tree.map(lambda g: g * scale, jgrads), st_j, jr.state.params)
        ut, st_t = opt_t.update({n: g * scale for n, g in tgrads.items()}, st_t)
        uj = to_torch_layout(uj)
        for name, w in uj.items():
            assert float((ut[name] - w).abs().max()) <= 1e-6 * LR, name
    adam = st_j[1][0]
    assert st_t.count == int(adam.count) == 3
    for mine, theirs in ((st_t.mu, adam.mu), (st_t.nu, adam.nu)):
        for name, w in to_torch_layout(theirs).items():
            np.testing.assert_allclose(mine[name].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=name)
    if kw.get("schedule"):
        sched = optax.cosine_decay_schedule(LR, 2, alpha=0.1)
        for count in range(4):
            assert opt_t.learning_rate(count) == pytest.approx(float(sched(count)), rel=1e-6)


def test_skipped_step_keeps_state_on_both_sides(three_steps, rng):
    # From the state after three steps, a batch with a NaN: loss NaN, update
    # skipped whole; parameters, Adam state and BatchNorm statistics unchanged
    # exactly, the step counted.
    _, jr, _ = three_steps
    bad = make_batch(rng, nan=True)
    jbefore = jax_state_payload(jr.state)
    state = port_state_from(jbefore)
    before = copy.deepcopy(state_payload(state))
    jstate, jloss = jr.step(jr.state, bad)
    state, loss = make_train_step(state.model, MultiScaleLoss(), default_optimizer())(state, bad)
    assert not np.isfinite(float(jloss)) and not np.isfinite(float(loss))
    jafter, after = jax_state_payload(jstate), state_payload(state)
    assert jafter["step"] == after["step"] == 4
    for b, a in ((jbefore, jafter), (before, after)):
        for k in b["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), k
        assert a["opt_state"]["count"] == b["opt_state"]["count"] == 3
        for m in ("mu", "nu"):
            for k in b["opt_state"][m]:
                assert torch.equal(a["opt_state"][m][k], b["opt_state"][m][k]), (m, k)


def test_make_train_step_refuses_non_fp32_parameters():
    model = UnrolledADMMGaussian(**NARROW, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        make_train_step(model, MultiScaleLoss(), default_optimizer())


def test_eval_step_uses_running_statistics(rng):
    batch = make_batch(rng)
    model = UnrolledADMMGaussian(**NARROW)
    state, _ = create_train_state(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = make_eval_step(model, MultiScaleLoss())(state, batch)
    assert not model.training and torch.isfinite(loss) and not loss.requires_grad
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_steps_run_with_tf32_off_and_restore_flags(rng, kind):
    # the caller turns TF32 on; inside the model's forward both flags read
    # False (the step enters utils/device.py::fp32_only), and after the step
    # the caller's True is back
    batch = make_batch(rng)
    model = UnrolledADMMGaussian(**NARROW)
    state, optimizer = create_train_state(model, 0)
    step = (make_train_step(model, MultiScaleLoss(), optimizer) if kind == "train"
            else make_eval_step(model, MultiScaleLoss()))
    seen = []
    model.register_forward_hook(lambda *_: seen.append(tf32_flags()))
    before = tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        step(state, batch)
        after = tf32_flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, False)]
    assert after == (True, True)


# --- data, checkpoints, command line -------------------------------------------


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    return chip_smoke().write_dataset(tmp_path_factory.mktemp("packed") / "data", n=24, seed=3)


def test_dataset_readers_match_jax(packed):
    # index for index, over three epochs of fit's shuffling (which compounds,
    # as the training indices are shuffled in place) and the val pass
    ds, jds = GalaxyDataset(packed), jdataset.GalaxyDataset(packed)
    assert len(ds) == len(jds) == 24
    tr, va = train_val_indices(24, 0.8, 3)
    jtr, jva = jdataset.train_val_indices(24, 0.8, 3)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(va, jva)
    runs = []
    for mod, d, idx_tr, idx_va in ((None, ds, tr, va), (jdataset, jds, jtr, jva)):
        it = iterate_batches if mod is None else mod.iterate_batches
        run = [b for e in range(3) for b in it(d, 5, shuffle=True, seed=3 + e, indices=idx_tr)]
        runs.append(run + list(it(d, 5, indices=idx_va, drop_last=False)))
    assert len(runs[0]) == len(runs[1]) == 3 * 3 + 1
    for b, jb in zip(*runs):
        assert b.keys() == jb.keys()
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


def test_checkpoint_roundtrip_and_epochs(tmp_path, rng):
    model = UnrolledADMMGaussian(**NARROW)
    state, optimizer = create_train_state(model, 7)
    state, _ = make_train_step(model, MultiScaleLoss(), optimizer)(state, make_batch(rng))
    for epoch in (1, 5, 3):
        path = save_checkpoint(tmp_path, "run", epoch, state)
    assert path.name == "run_3epochs" and (path / "train_state.pt").is_file()
    fresh = UnrolledADMMGaussian(**NARROW)
    restored = restore_checkpoint(tmp_path, "run", 3, TrainState(0, fresh, optimizer.init(fresh)))
    want, got = state_payload(state), state_payload(restored)
    assert got["step"] == want["step"] == 1 and got["opt_state"]["count"] == want["opt_state"]["count"] == 1
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for m in ("mu", "nu"):
        for k, v in want["opt_state"][m].items():
            assert torch.equal(got["opt_state"][m][k], v), (m, k)
    raw = restore_checkpoint(tmp_path, "run", 3)
    assert unpack_variables(raw).keys() == unpack_variables(restored).keys() == model.state_dict().keys()
    # epoch bookkeeping, the same answers as the JAX package's on one directory
    (tmp_path / "run_10epochs_extra").mkdir()
    assert latest_epoch(tmp_path, "run") == jckpt.latest_epoch(tmp_path, "run") == 5
    assert latest_epoch(tmp_path / "missing", "run") == 0
    assert best_epoch(tmp_path, "run") == 5
    (tmp_path / "run_history.json").write_text(json.dumps({"best_step": 3}))
    assert best_epoch(tmp_path, "run") == jckpt.best_epoch(tmp_path, "run") == 3


def test_cli_train_on_cpu(packed, tmp_path):
    save = tmp_path / "models"
    state, hist = cli.main(["train", "--data_path", str(packed), "--model_save_path", str(save), "--n_epochs", "1",
                            "--batch_size", "8", "--n_iters", "2", "--seed", "0", "--device", "cpu"])
    name = "Gaussian_PnP_ADMM_2iters_MultiScale"
    assert (save / f"{name}_1epochs" / "train_state.pt").is_file()
    history = json.loads((save / f"{name}_history.json").read_text())
    assert set(history) == {"train_loss", "val_loss", "epoch_time", "best_step", "best_epoch"}
    assert history["best_step"] == 1 and history["best_epoch"] == 0 and best_epoch(save, name) == 1
    assert np.isfinite(history["train_loss"] + history["val_loss"]).all()
    assert state.step == int(0.9 * 24) // 8 == 2
    assert next(state.model.parameters()).device.type == "cpu"


def test_cli_refuses_unported_models(packed):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["train", "--model", "Tikhonet", "--data_path", str(packed), "--device", "cpu"])
