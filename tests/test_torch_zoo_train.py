"""Port parity: the zoo's training pieces against the JAX package's train
steps, from one bridged state on the same numpy batches: Tikhonet's steps,
ADMMNet's and the two-dual UnrolledADMM's with a frozen denoiser (JAX:
``create_train_state(..., frozen_mask_fn)``, an ``optax.multi_transform``
with ``set_to_zero``), and frozen parameters outside the clip's norm.  Each
test states its tolerance and why."""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from galaxy_deconv_tpu.losses import multiscale as jms
from galaxy_deconv_tpu.models import admmnet as jadmmnet
from galaxy_deconv_tpu.models import tikhonet as jtikhonet
from galaxy_deconv_tpu.models import unrolled_admm as jadmm
from galaxy_deconv_tpu.train.state import create_train_state as jcreate_train_state
from galaxy_deconv_tpu.train.state import default_optimizer as jdefault_optimizer
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss
from galaxy_deconv_tpu_torch.models import ADMMNet, Tikhonet, UnrolledADMM
from galaxy_deconv_tpu_torch.models.tikhonet import tikhonov_solve
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer, make_train_step
from galaxy_deconv_tpu_torch.train.checkpoint import load_payload
from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict, train_state_payload
from test_torch_zoo import SMALL, as_np, jit, t, variables

LR = 2e-4


class Seeded:
    """A flax model for the JAX train state whose ``init`` is :func:`variables`."""

    def __init__(self, model):
        self.model = model

    def init(self, key, *args):
        return variables(self.model, *args)

    def apply(self, *args, **kwargs):
        return self.model.apply(*args, **kwargs)


def make_batch(rng, B=4):
    gt = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 5
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    obs = gt + rng.standard_normal((B, 48, 48)).astype(np.float32)
    return dict(obs=obs, psf=psf, gt=gt, alpha=obs.mean(axis=(1, 2)))


def jax_adam(opt_state):
    """The ScaleByAdamState of a chain(clip, adam) state, or of its
    multi_transform's 'train' branch."""
    if isinstance(opt_state, optax.MultiTransformState):
        opt_state = opt_state.inner_states["train"].inner_state
    return opt_state[1][0]


def jax_payload(st):
    adam = jax_adam(st.opt_state)
    return train_state_payload(as_np(st.params), as_np(st.batch_stats), as_np(adam.mu), as_np(adam.nu),
                               adam.count, st.step)


# flax's top-level parameter groups and the port's names for them
PREFIX = {"ResUNet_0": "resunet.", "SubNet_0": "subnet.", "XDenseUNet_0": "xdense_unet."}


class JaxStep:
    """JAX's train step (``galaxy_deconv_tpu/train/loop.py::make_train_step``:
    value_and_grad of the loss with train-mode BatchNorm, the optimizer's
    update, params + updates) as two jitted functions.  XLA's CPU compile of
    the fused step takes 70-80 s for the XDenseUNet; the two pieces ~25 s.
    The update is compiled as :func:`test_torch_zoo.jit` compiles (backend
    optimisation level 0, 4 s faster), which gives Tikhonet's updates bit
    for bit; the gradient is not: at level 0 the SubNet's BatchNorm-bias
    gradients move by up to 6e-3 of their largest entry, not the rounding
    these limits were read from."""

    def __init__(self, model, optimizer):
        def loss_of(params, stats, batch):
            variables = {"params": params, **({"batch_stats": stats} if stats else {})}
            rec, upd = model.apply(variables, batch["obs"], batch["psf"], batch["alpha"], True,
                                   mutable=["batch_stats"])
            return jms.MultiScaleLoss()(batch["gt"], rec), upd.get("batch_stats", stats)

        self.grad = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        self.update = jit(optimizer.update)

    def __call__(self, state, batch):
        """(new state, loss, the gradients in the port's names and layouts)."""
        (loss, stats), grads = self.grad(state.params, state.batch_stats, batch)
        updates, opt_state = self.update(grads, state.opt_state, state.params)
        params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        new = state.replace(step=state.step + 1, params=params, batch_stats=stats, opt_state=opt_state)
        return new, loss, model_state_dict(as_np(grads))


def run_steps(jmodel, tmodel, batch, n_steps, frozen_groups=()):
    """``n_steps`` train steps of each side from one bridged initial state, the
    MultiScale loss, Adam 2e-4 with clip 1.0; the flax groups in
    ``frozen_groups`` are frozen on both sides (JAX: its create_train_state's
    ``optax.multi_transform``).  Returns JAX's final state, the port's, and
    per step a dict of both losses, JAX's payload and gradients, the port's
    model state_dict and gradients."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mask = frozen = None
    if frozen_groups:
        def mask(params):
            return {k: jax.tree.map(lambda _, k=k: k in frozen_groups, v) for k, v in params.items()}

        def frozen(name):
            return name.startswith(tuple(PREFIX.get(g, g) for g in frozen_groups))
    opt = jdefault_optimizer(LR)  # its init (zeros) jitted: eagerly, one small compile per leaf shape
    opt = optax.GradientTransformation(jit(opt.init), opt.update)
    jstate, jopt = jcreate_train_state(Seeded(jmodel), jax.random.PRNGKey(0), jbatch, opt, frozen_mask_fn=mask)
    jstep = JaxStep(jmodel, jopt)
    tstate, topt = create_train_state(tmodel, 0, default_optimizer(LR), frozen_mask_fn=frozen)
    tstate = load_payload(tstate, jax_payload(jstate))
    tstep = make_train_step(tmodel, MultiScaleLoss(), topt)
    out = []
    for _ in range(n_steps):
        jstate, jloss, jgrads = jstep(jstate, jbatch)
        tstate, tloss = tstep(tstate, batch)
        out.append(dict(jloss=float(jloss), tloss=float(tloss), jstate=jax_payload(jstate), jgrads=jgrads,
                        tmodel={k: v.clone() for k, v in tmodel.state_dict().items()},
                        tgrads={n: p.grad.clone() for n, p in tmodel.named_parameters() if p.grad is not None}))
    return jstate, tstate, out


def zero_grad_param(name):
    """The SubNet's conv biases feed train-mode BatchNorm, which subtracts
    their effect: their exact gradient is 0 and both sides hold rounding
    noise (tests/test_torch_train.py)."""
    return re.fullmatch(r"subnet\.convs\.\d+\.conv\d\.bias", name) is not None


def assert_steps_follow_jax(steps, grad_rel, frozen=(), grad_rel_of_top=None):
    """Each step's loss at 1e-5; the first step's gradients to ``grad_rel`` of
    each tensor's largest JAX entry and, given ``grad_rel_of_top``, to that
    of the model's largest gradient, the zero-gradient biases to 1e-4 of the
    model's largest gradient on both sides; BatchNorm's running statistics
    after the first step at 1e-5; after the last step, every trained
    parameter within 0.02 lr of JAX's where the first step's JAX gradient is
    at least 0.1 of the model's largest, and within Adam's 2 lr per step
    elsewhere: where |g| is rounding noise, Adam's normalised step (~lr
    sign(g)) can go either way (tests/test_torch_train.py).  Frozen
    parameters: no gradient, bit for bit JAX's."""
    for st in steps:
        assert abs(st["tloss"] - st["jloss"]) <= 1e-5 * abs(st["jloss"])
    first, last = steps[0], steps[-1]
    assert not set(first["tgrads"]) & set(frozen)
    top = max(float(g.abs().max()) for g in first["jgrads"].values())
    per_tensor, of_top = {}, {}
    for name, got in first["tgrads"].items():
        want = first["jgrads"][name]
        if zero_grad_param(name):
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-4 * top, name
        else:
            d = float((got - want).abs().max())
            per_tensor[name], of_top[name] = d / float(want.abs().max()), d / top
    for readings, limit in ((per_tensor, grad_rel), (of_top, grad_rel_of_top)):
        worst = max(readings, key=readings.get)
        assert limit is None or readings[worst] <= limit, f"{worst}: {readings[worst]:.3e}"
    n = len(steps)
    for name, want in last["jstate"]["model"].items():
        got = last["tmodel"][name]
        if name in frozen:
            assert torch.equal(got, want), name
        elif "running_" in name:  # after the first step: later ones see parameters apart by the above
            np.testing.assert_allclose(first["tmodel"][name].numpy(), first["jstate"]["model"][name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        elif "num_batches" not in name and not zero_grad_param(name):
            d = (got - want).abs() / LR
            assert float(d.max()) <= 2 * n, name
            clear = first["jgrads"][name].abs() >= 0.1 * top
            if clear.any():
                assert float(d[clear].max()) <= 0.02, f"{name}: {float(d[clear].max()):.3g} lr"


def test_tikhonet_train_steps_match_jax():
    """Two steps of Tikhonet (Laplacian).  Gradients to 5e-2 of each tensor's
    largest JAX entry and to 1e-3 of the model's largest gradient.  Per
    tensor, JAX's own float32 gradients stray from float64 (the port's
    XDenseUNet in float64 on the same Tikhonov solve) by up to 2.3e-2 of a
    tensor's largest entry where the port's stray by 1.1e-3 (three batches);
    over the batches of rng seeds 5-10 the port reads 1.5e-3 to 2.3e-2 per
    tensor from JAX (2.3e-2 on this one), and 5e-5 to 1.9e-4 of the model's
    largest gradient.  The port's own float64 twin holds each of its tensors
    to 5e-3 of its largest entry."""
    batch = make_batch(np.random.default_rng(5))
    tmodel = Tikhonet(filter="Laplacian")
    _, tstate, steps = run_steps(jtikhonet.Tikhonet(filter="Laplacian"), tmodel, batch, 2)
    assert_steps_follow_jax(steps, 5e-2, grad_rel_of_top=1e-3)
    assert tstate.step == 2 and tstate.opt_state.count == 2

    # the port's gradients against its float64 twin, from the bridged initial state
    tmodel.load_state_dict(steps[0]["tmodel"])  # any weights: the last step's state
    tmodel.train()
    obs, psf, alpha, gt = (t(batch[k]) for k in ("obs", "psf", "alpha", "gt"))
    with torch.no_grad():
        x0 = tikhonov_solve(obs.clamp_min(0.0), psf, alpha, torch.nn.functional.softplus(tmodel.lam_raw))
    twin = copy.deepcopy(tmodel.xdense_unet).double()
    for net, dt in ((tmodel.xdense_unet, torch.float32), (twin, torch.float64)):
        net.zero_grad()
        MultiScaleLoss()(gt.to(dt), net(x0[:, None].to(dt))[:, 0] * alpha.to(dt)[:, None, None]).backward()
    for (name, p), q in zip(tmodel.xdense_unet.named_parameters(), twin.parameters()):
        assert float((p.grad.double() - q.grad).abs().max() / q.grad.abs().max()) <= 5e-3, name


def test_frozen_denoiser_train_steps_match_jax():
    """UnrolledADMM (Poisson) with its ResUNet frozen, the SubNet training
    (JAX: ``optax.multi_transform`` with ``set_to_zero``): the frozen
    parameters get no gradient and no Adam moments and stay bit for bit at
    the bridged weights; the rest follows JAX's steps, whose clip sees only
    their gradients.  Gradients to 5e-4, the flagship's limit."""
    batch = make_batch(np.random.default_rng(6))
    tmodel = UnrolledADMM(**SMALL)
    _, tstate, steps = run_steps(jadmm.UnrolledADMM(**SMALL), tmodel, batch, 2, ("ResUNet_0",))
    frozen = [n for n, _ in tmodel.named_parameters() if n.startswith("resunet.")]
    assert frozen and not any(tmodel.get_parameter(n).requires_grad for n in frozen)
    trained = {n for n, _ in tmodel.named_parameters()} - set(frozen)
    assert set(tstate.opt_state.mu) == set(steps[-1]["jstate"]["opt_state"]["mu"]) == trained
    assert_steps_follow_jax(steps, 5e-4, frozen)


def test_frozen_parameters_stay_out_of_the_clip_norm():
    """A frozen parameter is not among the optimizer's gradients: a train step
    with a frozen lam_raw updates the schedule exactly as ClippedAdam does on
    the schedule's gradients alone, and leaves lam_raw bit for bit."""
    model = UnrolledADMM(n_iters=1, features=(4, 4, 4, 4), pnp=False, subnet=False)
    state, opt = create_train_state(model, 0, default_optimizer(LR), frozen_mask_fn=lambda n: n == "lam_raw")
    assert not model.lam_raw.requires_grad and set(state.opt_state.mu) == {"rho1_iters", "rho2_iters"}
    batch = make_batch(np.random.default_rng(7), B=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    # what the step must do: the loss's gradients w.r.t. the schedule alone, through ClippedAdam
    probe = UnrolledADMM(n_iters=1, features=(4, 4, 4, 4), pnp=False, subnet=False)
    probe.load_state_dict(model.state_dict())
    loss = MultiScaleLoss()(t(batch["gt"]), probe.train()(*map(t, (batch["obs"], batch["psf"], batch["alpha"]))))
    grads = dict(zip(("rho1_iters", "rho2_iters"), torch.autograd.grad(loss, [probe.rho1_iters, probe.rho2_iters])))
    assert probe.lam_raw.requires_grad  # its gradient exists but must not reach the clip
    updates, _ = opt.update(grads, state.opt_state)
    state, _ = make_train_step(model, MultiScaleLoss(), opt)(state, batch)
    assert model.lam_raw.grad is None and torch.equal(model.lam_raw, before["lam_raw"])
    for n in grads:
        assert torch.equal(model.get_parameter(n).detach(), before[n] + updates[n]), n
    assert state.opt_state.count == 1


def test_admmnet_frozen_denoiser_step_matches_jax():
    """ADMMNet with its denoiser frozen has nothing to train: each step's loss
    matches JAX's at 1e-5, there are no gradients and no moments, and every
    parameter stays bit for bit."""
    batch = make_batch(np.random.default_rng(8))
    _, tstate, steps = run_steps(jadmmnet.ADMMNet(**SMALL), ADMMNet(**SMALL), batch, 2, ("ResUNet_0",))
    assert tstate.opt_state.mu == {} == steps[-1]["jstate"]["opt_state"]["mu"] and tstate.opt_state.count == 2
    for st in steps:
        assert abs(st["tloss"] - st["jloss"]) <= 1e-5 * abs(st["jloss"]) and not st["tgrads"]
        assert all(torch.equal(st["tmodel"][k], v) for k, v in st["jstate"]["model"].items())


