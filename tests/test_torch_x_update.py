"""Port parity: the x-update solve (ops/x_update.py) and the model's x_update
against the JAX package's TPU kernel, run in interpret mode, and its jnp
reference.  Solve tolerances 1e-5 and drop-in tolerances 1e-4, as in
tests/test_pallas.py.  The kernel itself runs only on a CUDA device: that test
is marked ``gpu`` and skips elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.models import unrolled_admm_gaussian as jmodel
from galaxy_deconv_tpu.ops.pallas_kernels import (
    x_update_batch_last,
    x_update_spectral,
    x_update_spectral_pallas,
)
from galaxy_deconv_tpu_torch.models import unrolled_admm_gaussian as tmodel
from galaxy_deconv_tpu_torch.ops import x_update as xu


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU build (run `pytest -m gpu` on the card)")
    return torch.device("cuda")


def planes(rng, K, B, hth=None, rho=None):
    arrs = [rng.standard_normal((K, B)).astype(np.float32) for _ in range(6)]
    hth = np.abs(rng.standard_normal((K, B))).astype(np.float32) + 0.1 if hth is None else hth
    rho = np.abs(rng.standard_normal((1, B))).astype(np.float32) + 0.1 if rho is None else rho
    return arrs, hth, rho


@pytest.mark.parametrize("K,B,ragged", [(4704, 128, False), (100, 70, True)])
def test_plain_solve_matches_jax_and_pallas(rng, K, B, ragged):
    if ragged:  # K and B not multiples of the (8, 128) blocks, as in test_pallas
        arrs, hth, rho = planes(rng, K, B, np.full((K, B), 0.5, np.float32), np.ones((1, B), np.float32))
    else:
        arrs, hth, rho = planes(rng, K, B)
    got = xu.x_update_spectral(*map(torch.from_numpy, (*arrs, hth, rho)))
    jargs = [jnp.asarray(a) for a in (*arrs, hth, rho)]
    for want in (x_update_spectral(*jargs), x_update_spectral_pallas(*jargs, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def batch_first(rng, B, shape=(96, 49)):
    """Kernel-layout inputs: Y, Ht, Z complex64, HtH, rho float32."""
    def cplx():
        return (rng.standard_normal((B, *shape)) + 1j * rng.standard_normal((B, *shape))).astype(np.complex64)
    hth = np.abs(rng.standard_normal((B, *shape))).astype(np.float32) + 0.1
    rho = np.abs(rng.standard_normal(B)).astype(np.float32) + 0.1
    return cplx(), cplx(), cplx(), hth, rho


def test_solve_layout_matches_pallas_planes(rng):
    # The complex batch-first twin against the TPU kernel on batch-last planes,
    # with Ht = conj(H) handed over as the kernel's H planes (Hr, -Im Ht).
    B = 128
    Y, Ht, Z, hth, rho = batch_first(rng, B)
    got = xu.x_update_solve(*map(torch.from_numpy, (Y, Ht, Z, hth, rho))).numpy()

    def plane(a):
        return jnp.asarray(a.reshape(B, -1).T)

    xr, xi = x_update_spectral_pallas(plane(Y.real), plane(Y.imag), plane(Ht.real), plane(-Ht.imag),
                                      plane(Z.real), plane(Z.imag), plane(hth), jnp.asarray(rho[None]),
                                      interpret=True)
    want = (np.asarray(xr).T + 1j * np.asarray(xi).T).reshape(Y.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_runs_plain_version_and_counts_nothing(rng):
    args = [torch.from_numpy(a) for a in batch_first(rng, 4)]
    before = xu.x_update_solve.launches
    got = xu.x_update_solve(*args)
    assert xu.x_update_solve.launches == before
    torch.testing.assert_close(got, xu.x_update_solve_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "lazy_conj"])
def test_wrapper_rejects_malformed_inputs(rng, bad):
    Y, Ht, Z, hth, rho = [torch.from_numpy(a) for a in batch_first(rng, 4)]
    if bad == "dtype":
        hth = hth.double()
    elif bad == "shape":
        rho = rho[:3]
    elif bad == "contiguity":
        Z = Z.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        Ht = Ht.conj()
    with pytest.raises((TypeError, ValueError)):
        xu.x_update_solve(Y, Ht, Z, hth, rho)


def xupdate_inputs(rng, B=4):
    y = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf = (np.abs(rng.standard_normal((B, 48, 48))) / 100).astype(np.float32)
    z = rng.standard_normal((B, 48, 48)).astype(np.float32)
    u = rng.standard_normal((B, 48, 48)).astype(np.float32)
    rho = np.abs(rng.standard_normal((B, 1, 1))).astype(np.float32) + 0.5
    return y, psf, z, u, rho


@pytest.mark.parametrize("impl", ["fft", "matmul"])
def test_model_x_update_matches_jax(rng, impl):
    y, psf, z, u, rho = xupdate_inputs(rng)
    jimpl = {"fft": "xla", "matmul": "matmul"}[impl]
    Yj, Htj, HtHj = jmodel.gaussian_spectra(jnp.asarray(y), jnp.asarray(psf), jimpl)
    want = np.asarray(jmodel.x_update(Yj, Htj, HtHj, jnp.asarray(z), jnp.asarray(u), jnp.asarray(rho), (48, 48), jimpl))
    want_pallas = np.asarray(x_update_batch_last(Yj, Htj, HtHj, jnp.asarray(z), jnp.asarray(u), jnp.asarray(rho),
                                                 (96, 96), interpret=True))
    Y, Ht, HtH = tmodel.gaussian_spectra(torch.from_numpy(y), torch.from_numpy(psf), impl)
    got = tmodel.x_update(Y, Ht, HtH, torch.from_numpy(z), torch.from_numpy(u), torch.from_numpy(rho), (48, 48),
                          impl).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(3)
    for B in (256, 3):
        args = [torch.from_numpy(a).to(cuda_device) for a in batch_first(rng, B)]
        before = xu.x_update_solve.launches
        got = xu.x_update_solve(*args)
        torch.cuda.synchronize()
        assert xu.x_update_solve.launches == before + 1
        torch.testing.assert_close(got, xu.x_update_solve_plain(*args), rtol=1e-5, atol=1e-5)
