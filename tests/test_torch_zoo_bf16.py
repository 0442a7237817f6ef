"""Port parity in bfloat16: the zoo's nets and models built with
``dtype=bfloat16`` (XDenseUNet in eval and train mode, UnrolledADMM with
each denoiser, ADMMNet and ADMMNet_fixed, the ResUNet denoiser) against the
flax modules with ``dtype=jnp.bfloat16`` on the same numpy inputs, the
weights carried by the bridge.  Tikhonet and ShapeNet take no dtype in
either package.

The method of tests/test_torch_model.py::test_bf16_nets_match_flax_bf16:
the frameworks round bf16 convolutions differently, so the two bf16 runs
differ about as much as bf16 differs from float32; the measure is
max |port - flax| / max |flax| of each output.  The same cases in float32,
port against flax, set the floor: 5.2e-7 to 1.4e-6 on the CPU.  Each case
has its own limit in BF16_REL, set from its reading on the CPU (the same at
1 and 8 threads; flax's own bf16 against its float32 in the comments):
about 1.3 times the reading, and below what a copy of the port with a
BatchNorm fault reads where that fault shows.  A copy whose BatchNorm
normalises in bf16 in eval mode moves UnrolledADMM(2) with XDenseUNet from
4.50e-3 to 5.29e-3 (and no other output); the direct check of that
normalisation, test_batchnorm_bf16_eval_normalises_in_float32, reads 405
bf16 ulps on that copy against 0 on the port.  No limit can tell a port
whose nets ran in float32 (it would read flax's own bf16 error), so the
nets' dtypes are checked apart.

XDenseUNet in train mode runs on positive stamps (20 |N(0,1)|, as
``bench.py``'s observations), whose channel means are large against their
spread: batch statistics summed in bf16 instead of float32 (the fault the
SubNet's BatchNorm once had) then move the running statistics by 1.51e-2 of
their largest entry (a copy of the port so changed), against 1.34e-4 when
they sum in float32 as flax does; BF16_STATS_REL sits between.  The
train-mode output reads 3.25e-3 either way.
"""

import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.models import denoiser as jdenoiser
from galaxy_deconv_tpu.models import registry as jregistry
from galaxy_deconv_tpu.models import unrolled_admm as jadmm
from galaxy_deconv_tpu.nets import xdense_unet as jxdense
from galaxy_deconv_tpu_torch.models import ResUNetDenoiser, UnrolledADMM, build_model
from galaxy_deconv_tpu_torch.nets import BatchNorm2d, XDenseUNet
from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict
from test_torch_zoo import SMALL, as_np, jit, nchw, stamps, t, variables, xdense_state_dict  # noqa: F401

# per output: the limit, about 1.3x the CPU reading (in the comment, flax's own bf16 against float32 in brackets)
BF16_REL = {
    "XDenseUNet eval": 6e-3,  # 4.76e-3 (5.10e-3)
    "XDenseUNet train": 4.5e-3,  # 3.25e-3
    "UnrolledADMM(2) with ResUNet": 2.2e-3,  # 1.68e-3 (1.66e-2)
    "UnrolledADMM(2) with XDenseUNet": 4.9e-3,  # 4.50e-3 (4.21e-3); 5.29e-3 when BatchNorm eval runs in bf16
    "ADMMNet(2)": 2.2e-2,  # 1.72e-2 (2.20e-2)
    "ADMMNet_fixed(2)": 1.7e-2,  # 1.32e-2 (1.62e-2)
    "ResUNet denoiser": 4.4e-3,  # 3.39e-3 (1.21e-2)
}
BF16_STATS_REL = 1e-3
BN_ULPS = 1.0


def rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_bf16_close(got, want, what: str, limit: float | None = None):
    limit = BF16_REL[what] if limit is None else limit
    err = rel(got, want)
    print(f"{what}: port bf16 vs flax bf16 {err:.2e}")
    assert err <= limit, f"{what}: max |port - flax| / max |flax| = {err:.3e} > {limit}"


@pytest.fixture
def rng():
    """Each test's own generator: the session's would make the readings depend on the tests run before."""
    return np.random.default_rng(43)


@pytest.fixture(scope="module")
def xdense_variables():
    return variables(jxdense.XDenseUNet(), np.zeros((1, 48, 48, 1), np.float32))


def xdense_bf16(v) -> XDenseUNet:
    tm = XDenseUNet(dtype=torch.bfloat16)
    tm.load_state_dict(xdense_state_dict(v["params"], v["batch_stats"]))
    return tm


def assert_net_dtypes(model: torch.nn.Module) -> tuple[int, int]:
    """Every convolution of ``model`` holds bf16 weights; every BatchNorm keeps
    float32 parameters and statistics.  Returns their counts."""
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert convs and all(p.dtype == torch.bfloat16 for m in convs for p in m.parameters())
    assert all(x.dtype == torch.float32 for m in norms for x in (*m.parameters(), *m.buffers())
               if x.is_floating_point())
    return len(convs), len(norms)


def test_xdense_unet_bf16_parameter_dtypes(xdense_variables):
    """Convolutions hold and compute bf16; every BatchNorm keeps float32
    parameters and statistics, after a load of the bridge's float32 arrays."""
    tm = xdense_bf16(xdense_variables)
    assert assert_net_dtypes(tm) == (1 + 2 * 37 + 3 + 3 + 1, 37 + 3)
    with torch.no_grad():
        out = tm.eval()(torch.ones(1, 1, 48, 48))
    assert out.dtype == torch.bfloat16


def test_batchnorm_bf16_eval_normalises_in_float32(rng):
    """Eval mode on bf16 activations against flax's ``BatchNorm(dtype=bfloat16,
    use_running_average=True)``, which normalises in float32 and rounds once.
    The running statistics are far from (0, 1), as a trained net's are
    (means ~20, spreads ~1): normalising in bf16 then loses the mean's low
    bits.  Each output is within BN_ULPS bf16 ulps of flax's (0 on the CPU;
    a copy of the port normalising in bf16 reads 405)."""
    C = 8
    x = (20 + rng.standard_normal((2, 6, 6, C))).astype(jnp.bfloat16)
    stats = {"mean": 20 + 0.3 * rng.standard_normal(C), "var": 0.5 + rng.random(C)}
    params = {"scale": 1 + 0.5 * rng.standard_normal(C), "bias": rng.standard_normal(C)}
    stats, params = ({k: v.astype(np.float32) for k, v in d.items()} for d in (stats, params))
    jm = flax_nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)), np.float32)
    bn = BatchNorm2d(C, eps=1e-5, momentum=0.1)
    bn.load_state_dict({"weight": t(params["scale"]), "bias": t(params["bias"]), "running_mean": t(stats["mean"]),
                        "running_var": t(stats["var"]), "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = bn.eval()(torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0**16  # float32 spacing * 2^(23 - 7)
    ulps = float((np.abs(got - want) / ulp).max())
    print(f"BatchNorm eval bf16: {ulps:.2f} bf16 ulps from flax")
    assert ulps <= BN_ULPS, f"BatchNorm eval in bf16 is {ulps:.2f} bf16 ulps from flax's > {BN_ULPS}"


def test_xdense_unet_bf16_eval_matches_flax_bf16(rng, xdense_variables):
    x = rng.standard_normal((2, 48, 48, 1)).astype(np.float32)
    v = xdense_variables
    want = np.asarray(jit(jxdense.XDenseUNet(dtype=jnp.bfloat16).apply)(v, x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = xdense_bf16(v).eval()(nchw(x))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, "XDenseUNet eval")


def test_xdense_unet_bf16_train_mode_matches_flax_bf16(rng, xdense_variables):
    """Batch statistics of bf16 activations, computed in float32 on both
    sides; the running statistics after the step at BF16_STATS_REL."""
    x = 20 * np.abs(rng.standard_normal((3, 48, 48, 1))).astype(np.float32)
    v = xdense_variables
    jm = jxdense.XDenseUNet(dtype=jnp.bfloat16)
    want, upd = jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    tm = xdense_bf16(v)
    with torch.no_grad():
        got = tm.train()(nchw(x))
    assert_bf16_close(got, np.asarray(want).transpose(0, 3, 1, 2), "XDenseUNet train")
    stats = xdense_state_dict(v["params"], as_np(upd["batch_stats"]))
    sd = tm.state_dict()
    running = sorted(k for k in stats if "running_" in k)
    assert len(running) == 2 * 40
    assert all(sd[k].dtype == torch.float32 for k in running)
    got_all, want_all = (torch.cat([d[k].ravel() for k in running]) for d in (sd, stats))
    assert_bf16_close(got_all, want_all.numpy(), "XDenseUNet running statistics", BF16_STATS_REL)


def bf16_pair(jfactory, tfactory, obs, psf, alpha):
    """Seeded variables for the flax model built in bf16 (a float32 tree),
    carried into the port's model built in bf16; both models' outputs."""
    jm = jfactory(jnp.bfloat16)
    v = variables(jm, obs, psf, alpha)
    tm = tfactory(torch.bfloat16)
    tm.load_state_dict(model_state_dict(v["params"], v.get("batch_stats")))
    assert_net_dtypes(tm)
    want = np.asarray(jit(jm.apply)(v, *map(jnp.asarray, (obs, psf, alpha))))
    with torch.no_grad():
        got = tm.eval()(*map(t, (obs, psf, alpha)))
    assert got.dtype == torch.float32  # the solvers' loop variables stay float32
    return got, want


@pytest.mark.parametrize("denoiser", ["ResUNet", "XDenseUNet"])
def test_unrolled_admm_bf16_matches_flax_bf16(stamps, denoiser):
    kw = dict(SMALL, llh="Poisson", denoiser=denoiser)
    got, want = bf16_pair(lambda d: jadmm.UnrolledADMM(**kw, dtype=d), lambda d: UnrolledADMM(**kw, dtype=d),
                          *stamps)
    assert_bf16_close(got, want, f"UnrolledADMM(2) with {denoiser}")


@pytest.mark.parametrize("name", ["ADMMNet", "ADMMNet_fixed"])
def test_admmnet_bf16_matches_flax_bf16(stamps, name):
    got, want = bf16_pair(lambda d: jregistry.build_model(name, **SMALL, dtype=d),
                          lambda d: build_model(name, **SMALL, dtype=d), *stamps)
    assert_bf16_close(got, want, f"{name}(2)")


def test_resunet_denoiser_bf16_matches_flax_bf16(stamps):
    features = SMALL["features"]
    got, want = bf16_pair(lambda d: jdenoiser.ResUNetDenoiser(features=features, dtype=d),
                          lambda d: ResUNetDenoiser(features=features, dtype=d), *stamps)
    assert_bf16_close(got, want, "ResUNet denoiser")
