"""Port parity: galaxy_deconv_tpu_torch.nets against the flax nets, with the
flax weights carried across by the weight bridge (utils/convert_flax.py).
Inputs are NHWC for flax and NCHW for the port.  Tolerances rtol 1e-4,
atol 1e-5 as tests/test_convert.py holds a converted layer; the whole nets
(up to 31 convolutions summed in another order) at rtol 1e-4, atol 1e-4."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.nets import blocks as jblocks
from galaxy_deconv_tpu.nets import resunet as jresunet
from galaxy_deconv_tpu.nets import subnet as jsubnet
from galaxy_deconv_tpu_torch.nets import BatchNorm2d, DoubleConv, DownConv, ResBlock, ResUNet, SubNet, UpConvTranspose
from galaxy_deconv_tpu_torch.nets.subnet import psf_power_spectrum
from galaxy_deconv_tpu_torch.utils import convert_flax


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module.eval()


def nhwc_to_nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def check(got, want_nhwc, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_nhwc).transpose(0, 3, 1, 2), rtol=rtol, atol=atol)


def test_resblock(rng):
    x = jnp.asarray(rng.standard_normal((2, 12, 12, 8)).astype(np.float32))
    mod = jblocks.ResBlock(8)
    p = as_np(mod.init(jax.random.PRNGKey(0), x)["params"])
    t = load(ResBlock(8), {"conv0.weight": convert_flax.conv_weight(p["Conv_0"]["kernel"]),
                           "conv1.weight": convert_flax.conv_weight(p["Conv_1"]["kernel"])})
    check(t(nhwc_to_nchw(x)), mod.apply({"params": p}, x))


def test_downconv(rng):
    x = jnp.asarray(rng.standard_normal((2, 12, 12, 8)).astype(np.float32))
    mod = jblocks.DownConv(16)
    p = as_np(mod.init(jax.random.PRNGKey(1), x)["params"])
    t = load(DownConv(8, 16), {"weight": convert_flax.conv_weight(p["Conv_0"]["kernel"])})
    check(t(nhwc_to_nchw(x)), mod.apply({"params": p}, x))


def test_upconv_transpose_kernel_flip(rng):
    x = jnp.asarray(rng.standard_normal((2, 6, 6, 16)).astype(np.float32))
    mod = jblocks.UpConvTranspose(8)
    p = as_np(mod.init(jax.random.PRNGKey(2), x)["params"])
    t = load(UpConvTranspose(16, 8), {"weight": convert_flax.conv_transpose_weight(p["ConvTranspose_0"]["kernel"])})
    check(t(nhwc_to_nchw(x)), mod.apply({"params": p}, x))


def random_bn_stats(rng, variables):
    """Non-identity BatchNorm statistics so eval-mode BN is exercised."""
    stats = as_np(variables["batch_stats"])
    return jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) + 0.5, stats)


def test_double_conv_eval_mode(rng):
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    mod = jblocks.DoubleConv(8)
    v = mod.init(jax.random.PRNGKey(3), x)
    p, s = as_np(v["params"]), random_bn_stats(rng, v)
    sd = convert_flax.subnet_state_dict({"DoubleConv_0": p}, {"DoubleConv_0": s})
    t = load(DoubleConv(4, 8), {k.removeprefix("convs.0."): v for k, v in sd.items()})
    check(t(nhwc_to_nchw(x)), mod.apply({"params": p, "batch_stats": s}, x))


def test_batchnorm_bf16_keeps_fp32_statistics(rng):
    """bf16 input, eval mode: flax's BatchNorm(dtype=bf16) keeps float32
    statistics and parameters, normalises in float32 and rounds once to bf16,
    so the port agrees to one bf16 ulp (rtol 2**-7).  Means of 30 against
    variances of 0.02-0.05 make statistics rounded to bf16 (ulp 0.125 at 30)
    move the outputs by many ulps."""
    C = 16
    x = jnp.asarray(30 + 0.2 * rng.standard_normal((2, 6, 6, C)), jnp.bfloat16)
    mod = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jnp.bfloat16)
    p = {"scale": rng.uniform(0.5, 2.0, C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32)}
    s = {"mean": (30 + 0.1 * rng.standard_normal(C)).astype(np.float32),
         "var": rng.uniform(0.02, 0.05, C).astype(np.float32)}
    want = mod.apply({"params": p, "batch_stats": s}, x)
    assert want.dtype == jnp.bfloat16
    sd = {k.removeprefix("bn."): v for k, v in convert_flax._batch_norm(p, s, "bn").items()}
    t = load(BatchNorm2d(C, eps=1e-5), {**sd, "num_batches_tracked": np.zeros((), np.int64)})
    got = t(nhwc_to_nchw(x.astype(jnp.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and t.running_mean.dtype == t.weight.dtype == torch.float32
    check(got.float(), want.astype(jnp.float32), rtol=2**-7, atol=0)


def test_double_conv_bf16_parameter_dtypes():
    m = DoubleConv(4, 8, dtype=torch.bfloat16)
    assert m.conv0.weight.dtype == m.conv1.bias.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for bn in (m.bn0, m.bn1) for t in (*bn.parameters(), *bn.buffers())
               if t.is_floating_point())
    out = m.eval()(torch.ones(1, 4, 8, 8, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("features", [(8, 8, 8, 8), (8, 16, 16, 32)])
@pytest.mark.parametrize("hw", [48, 45])
def test_resunet(rng, features, hw):
    x = jnp.asarray(rng.standard_normal((2, hw, hw, 1)).astype(np.float32))
    mod = jresunet.ResUNet(features=features)
    p = as_np(mod.init(jax.random.PRNGKey(4), x)["params"])
    t = load(ResUNet(features), convert_flax.resunet_state_dict(p))
    check(t(nhwc_to_nchw(x)), mod.apply({"params": p}, x), atol=1e-4)


def subnet_inputs(rng, B=3):
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    alpha = rng.uniform(10, 200, B).astype(np.float32)
    return psf, alpha


def test_psf_power_spectrum(rng):
    psf, _ = subnet_inputs(rng)
    np.testing.assert_allclose(psf_power_spectrum(torch.from_numpy(psf)).numpy(),
                               np.asarray(jsubnet.psf_power_spectrum(jnp.asarray(psf))), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("raw", [False, True])
def test_subnet_eval_mode(rng, raw):
    psf, alpha = subnet_inputs(rng)
    mod = jsubnet.SubNet(n_outputs=8, raw=raw)
    v = mod.init(jax.random.PRNGKey(5), jnp.asarray(psf), jnp.asarray(alpha))
    p, s = as_np(v["params"]), random_bn_stats(rng, v)
    want = np.asarray(mod.apply({"params": p, "batch_stats": s}, jnp.asarray(psf), jnp.asarray(alpha)))
    t = load(SubNet(8, raw=raw), convert_flax.subnet_state_dict(p, s))
    got = t(torch.from_numpy(psf), torch.from_numpy(alpha)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
