"""Port parity: ``pipeline.init_parameters`` against flax's default kernel
initialiser, ``lecun_normal``: a normal truncated at two standard deviations
and scaled to variance 1/fan_in, so |w| * sqrt(fan_in) <= 2 / 0.8796 =
2.2737.  Held against flax-initialised variables of the same JAX modules (a
wide 3x3 convolution, the ResUNet's transposed convolution, the SubNet's dense
layers), each tensor's draws scaled by sqrt(fan_in): the bound, the standard
deviation and a two-sample Kolmogorov-Smirnov statistic, which the plain
untruncated N(0, 1/fan_in) draw the port used to make must fail."""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from galaxy_deconv_tpu.nets import blocks as jblocks
from galaxy_deconv_tpu.nets import subnet as jsubnet
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.nets import ResBlock, SubNet, UpConvTranspose
from galaxy_deconv_tpu_torch.pipeline import init_parameters

# 2 / 0.87962566 = 2.273694; float32 rounding of the draw and the scale may
# add a few ulps
MAX_SCALED = 2.2743
STD_REL = 0.02
# Two-sample KS statistic between the port's and flax's scaled draws.  The
# exact distance between the truncated law and N(0, 1) is 0.0167; with 7e4 to
# 6e5 draws a side, sampling alone reads below 1.36 sqrt(2/n) = 0.0025 to
# 0.0073 at 95 %.  Readings on the
# CPU: truncated draw 0.0012 (wide conv), 0.0024 (transposed conv), 0.0048
# (dense layers); the old untruncated draw 0.0173, 0.0172, 0.0208.  Standard
# deviations read within 0.4 % of flax's.
KS_MAX = 0.008


def fan_in(mod: nn.Module) -> int:
    """Inputs x taps of the flax kernel that the torch weight holds."""
    w = mod.weight
    return w.shape[0 if isinstance(mod, nn.ConvTranspose2d) else 1] * math.prod(w.shape[2:])


def flax_fan_in(kernel: np.ndarray) -> int:
    """lecun_normal's fan_in: every axis of a flax kernel but the last (its outputs)."""
    return math.prod(kernel.shape[:-1])


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    both = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, both, side="right") / a.size
                        - np.searchsorted(b, both, side="right") / b.size).max())


def old_draw(mod: nn.Module, seed: int) -> np.ndarray:
    """The untruncated N(0, 1/fan_in) draw, scaled by sqrt(fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(mod.weight.shape, generator=gen).numpy().ravel()


def wide_conv():
    port = ResBlock(256)
    init_parameters(port, 0)
    kernel = fnn.Conv(256, (3, 3), padding="SAME", use_bias=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 256)))["params"]["kernel"]
    return [port.conv0], [np.asarray(kernel)]


def transposed_conv():
    port = UpConvTranspose(256, 128)
    init_parameters(port, 0)
    params = jblocks.UpConvTranspose(128).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 256)))["params"]
    return [port], [np.asarray(k) for k in jax.tree.leaves(params)]


def dense_layers():
    port = SubNet(8)
    init_parameters(port, 0)
    params = jsubnet.SubNet(8).init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48)), jnp.ones((1,)))["params"]
    return list(port.dense), [np.asarray(params[f"Dense_{i}"]["kernel"]) for i in range(3)]


@pytest.mark.parametrize("case", [wide_conv, transposed_conv, dense_layers], ids=lambda f: f.__name__)
def test_init_matches_flax_lecun_normal(case):
    mods, kernels = case()
    assert [m.weight.numel() for m in mods] == [k.size for k in kernels]
    assert [fan_in(m) for m in mods] == [flax_fan_in(k) for k in kernels]
    got = np.concatenate([m.weight.detach().numpy().ravel() * math.sqrt(fan_in(m)) for m in mods])
    want = np.concatenate([k.ravel() * math.sqrt(flax_fan_in(k)) for k in kernels])
    old = np.concatenate([old_draw(m, 0) for m in mods])

    assert np.abs(want).max() <= MAX_SCALED
    assert np.abs(got).max() <= MAX_SCALED
    assert abs(got.std() / want.std() - 1) <= STD_REL
    assert ks_statistic(got, want) <= KS_MAX
    # the test tells the old draw apart: it exceeds the bound and the KS limit
    assert np.abs(old).max() > MAX_SCALED
    assert ks_statistic(old, want) > KS_MAX


def flagship(seed, subnet=True):
    model = UnrolledADMMGaussian(n_iters=8, features=(32, 64, 128, 256), subnet=subnet)
    init_parameters(model, seed)
    return model


def test_flagship_weights_within_truncation():
    model = flagship(0)
    layers = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    assert len(layers) == 47  # ResUNet 36 (head, tail, 3 down, 3 up, 28 in ResBlocks), SubNet 8 conv + 3 dense
    for m in layers:
        assert float(m.weight.detach().abs().max()) * math.sqrt(fan_in(m)) <= MAX_SCALED
        if m.bias is not None:
            assert not m.bias.any()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and not m.bias.any()


def test_learnt_schedule_starts_at_one():
    # galaxy_deconv_tpu/models/unrolled_admm_gaussian.py initialises rho_iters to ones
    model = flagship(0, subnet=False)
    assert model.rho_iters.shape == (8,)
    assert torch.equal(model.rho_iters, torch.ones_like(model.rho_iters))


def test_same_seed_same_weights():
    a, b, c = flagship(0).state_dict(), flagship(0).state_dict(), flagship(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    weights = [k for k in a if k.endswith("weight") and a[k].ndim >= 2]
    assert not any(torch.equal(a[k], c[k]) for k in weights)
