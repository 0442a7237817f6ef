"""Port parity: the x-update solve (ops/x_update.py) and the model's x_update
against the JAX package's TPU kernel, run in interpret mode, and its jnp
reference.  Solve tolerances 1e-5 and drop-in tolerances 1e-4, as in
tests/test_pallas.py.  The solve's gradient (the autograd function and the
backward kernel's plain version) against torch autograd and jax.grad.  The
kernels themselves run only on a CUDA device: those tests are marked ``gpu``
and skip elsewhere."""

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


# --- the solve's gradient (autograd function XUpdateSolve, backward kernel) ---


def rho_term_scale(G, X, hth, rho):
    """Per galaxy, the sum of the magnitudes of grad_rho's terms: float32
    rounding of that 4,704-term sum, in any order, is ~1e-8 of it."""
    d = rho.reshape(-1, 1, 1) + hth
    return (((G.real * X.real).abs() + (G.imag * X.imag).abs()) / d).sum(dim=(1, 2)).double()


def as64(t):
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def test_backward_plain_matches_autograd_of_plain(rng):
    # float64: the two compute the same formulas, so they agree to rounding (1e-12)
    Y, Ht, Z, hth, rho = [as64(torch.from_numpy(a)) for a in batch_first(rng, 4)]
    Z.requires_grad_()
    rho.requires_grad_()
    X = xu.x_update_solve_plain(Y, Ht, Z, hth, rho)
    G = as64(torch.from_numpy(batch_first(rng, 4)[0]))
    want_z, want_rho = torch.autograd.grad(X, (Z, rho), grad_outputs=G)
    got_z, got_rho = xu.x_update_solve_backward_plain(G, X.detach(), hth, rho.detach())
    torch.testing.assert_close(got_z, want_z, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_rho, want_rho, rtol=1e-12, atol=1e-12)


def test_solve_function_gradient_on_cpu(rng):
    # x_update_solve's gradient (float32, the plain backward on the CPU)
    # against the float64 autograd of the plain solve: grad_Z at 1e-5, grad_rho
    # at 1e-6 of the sum of its terms' magnitudes (see rho_term_scale).
    args = [torch.from_numpy(a) for a in batch_first(rng, 4)]
    G = torch.from_numpy(batch_first(rng, 4)[0])
    Z, rho = args[2].clone().requires_grad_(), args[4].clone().requires_grad_()
    X = xu.x_update_solve(args[0], args[1], Z, args[3], rho)
    got_z, got_rho = torch.autograd.grad(X, (Z, rho), grad_outputs=G)
    Z64, rho64 = as64(args[2]).requires_grad_(), as64(args[4]).requires_grad_()
    X64 = xu.x_update_solve_plain(as64(args[0]), as64(args[1]), Z64, as64(args[3]), rho64)
    want_z, want_rho = torch.autograd.grad(X64, (Z64, rho64), grad_outputs=as64(G))
    np.testing.assert_allclose(got_z.numpy(), want_z.numpy(), rtol=1e-5, atol=1e-5)
    scale = rho_term_scale(G, X.detach(), args[3], args[4])
    assert float(((got_rho.double() - want_rho).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("name", ["Y", "Ht", "HtH"])
def test_solve_refuses_gradient_for_observation_spectra(rng, name):
    Y, Ht, Z, hth, rho = [torch.from_numpy(a) for a in batch_first(rng, 2)]
    {"Y": Y, "Ht": Ht, "HtH": hth}[name].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        xu.x_update_solve(Y, Ht, Z, hth, rho)
    with torch.no_grad():
        xu.x_update_solve(Y, Ht, Z, hth, rho)


@pytest.mark.parametrize("impl", ["fft", "matmul"])
def test_model_x_update_gradient_matches_jax(rng, impl):
    # d/dz and d/drho of sum(w * x_update(...)) against jax.grad of the JAX
    # x_update(impl="xla" / "matmul"), at the drop-in tolerance of 1e-4
    # (grad_rho relative to its largest entry: a sum over 96 x 49 spectra).
    # Readings: grad_z 1.2e-6 absolute (max 3.4), grad_rho 5.9e-7 relative.
    import jax

    y, psf, z, u, rho = xupdate_inputs(rng)
    w = rng.standard_normal(z.shape).astype(np.float32)
    jimpl = {"fft": "xla", "matmul": "matmul"}[impl]
    Yj, Htj, HtHj = jmodel.gaussian_spectra(jnp.asarray(y), jnp.asarray(psf), jimpl)

    def loss(zz, rr):
        return jnp.sum(jnp.asarray(w) * jmodel.x_update(Yj, Htj, HtHj, zz, jnp.asarray(u), rr, (48, 48), jimpl))

    want_z, want_rho = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(rho)))
    Y, Ht, HtH = tmodel.gaussian_spectra(torch.from_numpy(y), torch.from_numpy(psf), impl)
    zt, rt = torch.from_numpy(z).requires_grad_(), torch.from_numpy(rho).requires_grad_()
    (torch.from_numpy(w) * tmodel.x_update(Y, Ht, HtH, zt, torch.from_numpy(u), rt, (48, 48), impl)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want_z, rtol=1e-4, atol=1e-4)
    assert np.abs(rt.grad.numpy() - want_rho).max() <= 1e-4 * np.abs(want_rho).max()


@pytest.mark.gpu
def test_backward_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(4)
    for B in (32, 256, 3):
        Y, Ht, Z, hth, rho = [torch.from_numpy(a).to(cuda_device) for a in batch_first(rng, B)]
        Z.requires_grad_()
        rho.requires_grad_()
        G = torch.from_numpy(batch_first(rng, B)[0]).to(cuda_device)
        fwd, bwd = xu.x_update_solve.launches, xu.x_update_solve_backward.launches
        X = xu.x_update_solve(Y, Ht, Z, hth, rho)
        got_z, got_rho = torch.autograd.grad(X, (Z, rho), grad_outputs=G)
        torch.cuda.synchronize()
        assert (xu.x_update_solve.launches, xu.x_update_solve_backward.launches) == (fwd + 1, bwd + 1)
        want_z, want_rho = xu.x_update_solve_backward_plain(as64(G), as64(X.detach()), as64(hth), as64(rho.detach()))
        torch.testing.assert_close(got_z, want_z.to(torch.complex64), rtol=1e-5, atol=1e-5)
        scale = rho_term_scale(G, X.detach(), hth, rho.detach())
        assert float(((got_rho.double() - want_rho).abs() / scale).max()) <= 1e-6
