"""Port parity: galaxy_deconv_tpu_torch.ops.{fourier, dft, resize} against the
JAX package on the same numpy inputs.  Transform tolerances are those of
tests/test_dft.py: rtol 2e-5, atol 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.ops import dft as jdft
from galaxy_deconv_tpu.ops import fourier as jfourier
from galaxy_deconv_tpu.ops import resize as jresize
from galaxy_deconv_tpu_torch.ops import dft, fourier, resize

RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw", [(48, 48), (24, 32), (7, 10)])
def test_fourier_layout_ops(rng, hw):
    x = rng.standard_normal((3, *hw)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    close(fourier.fftshift2(t), jfourier.fftshift2(j), 0, 0)
    close(fourier.ifftshift2(t), jfourier.ifftshift2(j), 0, 0)
    close(fourier.pad_double(t), jfourier.pad_double(j), 0, 0)
    close(fourier.crop_half(fourier.pad_double(t)), jfourier.crop_half(jfourier.pad_double(j)), 0, 0)
    close(fourier.pad_to_size_centered(t, (60, 61)), jfourier.pad_to_size_centered(j, (60, 61)), 0, 0)


@pytest.mark.parametrize("hw", [(48, 48), (96, 96), (24, 32)])
def test_rfft2_irfft2(rng, hw):
    x = rng.standard_normal((2, *hw)).astype(np.float32)
    X = fourier.rfft2(torch.from_numpy(x))
    close(X, jfourier.rfft2(jnp.asarray(x)))
    close(fourier.irfft2(X, hw), jfourier.irfft2(jfourier.rfft2(jnp.asarray(x)), hw))


@pytest.mark.parametrize("hw", [(48, 48), (24, 32)])
def test_spec_rfft2_padded(rng, hw):
    x = rng.standard_normal((3, *hw)).astype(np.float32)
    close(dft.spec_rfft2_padded(torch.from_numpy(x)), jdft.spec_rfft2_padded(jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(48, 48), (24, 32)])
def test_spec_irfft2_cropped(rng, hw):
    S = np.asarray(jdft.spec_rfft2_padded(jnp.asarray(rng.standard_normal((3, *hw)).astype(np.float32))))
    S = (S * (1.0 + 0.3j)).astype(np.complex64)  # off the exact round-trip
    close(dft.spec_irfft2_cropped(torch.from_numpy(S), hw), jdft.spec_irfft2_cropped(jnp.asarray(S), hw))


@pytest.mark.parametrize("n,rfft", [(48, False), (48, True), (24, True)])
def test_dft_plans_equal_jax(n, rfft):
    for mine, theirs in ((dft._plan, jdft._plan), (dft._iplan, jdft._iplan)):
        for a, b in zip(mine(n, rfft), theirs(n, rfft)):
            np.testing.assert_array_equal(a, b)


def test_matmul_spectra_restore_tf32_setting(rng):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        dft.spec_rfft2_padded(torch.from_numpy(rng.standard_normal((1, 8, 8)).astype(np.float32)))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("hw", [(48, 48), (45, 45), (13, 20)])
def test_pad_to_multiple_edge(rng, hw):
    x = rng.standard_normal((2, 3, *hw)).astype(np.float32)  # NCHW
    got, got_hw = resize.pad_to_multiple_edge(torch.from_numpy(x), 8)
    want, want_hw = jresize.pad_to_multiple_edge(jnp.asarray(x.transpose(0, 2, 3, 1)), 8)
    assert got_hw == want_hw == hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
