"""Port parity: the classical-deblurring utilities (galaxy_deconv_tpu_torch/ops/deblur.py)
against the JAX package's (galaxy_deconv_tpu/ops/deblur.py), each function on
the same seeded numpy inputs.  Each test states its tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.ops import deblur as J
from galaxy_deconv_tpu_torch.ops import deblur as T


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def test_the_same_functions_as_jax():
    assert T.__all__ == J.__all__


@pytest.mark.parametrize("size,sigma", [(15, 2.0), (16, 1.3), (25, 4.0)])
def test_gauss_kernel_matches_jax(size, sigma):
    # float32 exp on the same symmetric grid: 1e-6 relative
    np.testing.assert_allclose(T.gauss_kernel(size, sigma).numpy(), np.asarray(J.gauss_kernel(size, sigma)),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("size,r", [(15, 4.0), (16, 5.5), (8, 0.3)], ids=["odd", "even", "degenerate"])
def test_disk_matches_jax(size, r):
    # the same pixels selected (bit for bit); r = 0.3 selects none, and both fall back to the nearest pixels
    np.testing.assert_array_equal(T.disk(size, r).numpy(), np.asarray(J.disk(size, r)))


def test_shrinkage_matches_jax(rng):
    z = rng.standard_normal((3, 20, 20)).astype(np.float32)
    np.testing.assert_array_equal(T.shrinkage(torch.from_numpy(z), 0.4).numpy(), np.asarray(J.shrinkage(z, 0.4)))


def test_tv_grad_and_adjoint_match_jax(rng):
    # differences of rolled copies, bit for bit; <D u, p> = <u, D* p> at 1e-5
    u = rng.standard_normal((2, 12, 14)).astype(np.float32)
    px, py = (rng.standard_normal(u.shape).astype(np.float32) for _ in range(2))
    for got, want in zip(T.tv_grad(torch.from_numpy(u)), J.tv_grad(jnp.asarray(u))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    adj = T.tv_grad_adjoint(torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_array_equal(adj.numpy(), np.asarray(J.tv_grad_adjoint(px, py)))
    dux, duy = T.tv_grad(torch.from_numpy(u))
    lhs = float((dux * torch.from_numpy(px) + duy * torch.from_numpy(py)).sum())
    assert abs(lhs - float((torch.from_numpy(u) * adj).sum())) <= 1e-5 * abs(lhs)


def test_gradient_mask_matches_jax(rng):
    # summed-area 5x5 box filters in float32 (cumulative sums over 52 rows and
    # columns, each framework in its own order): every output at 5e-5 of its
    # peak (reading 1.6e-5)
    dx, dy = (rng.standard_normal((2, 48, 48)).astype(np.float32) for _ in range(2))
    got = T.gradient_mask(torch.from_numpy(dx), torch.from_numpy(dy), 0.1, 0.2)
    want = J.gradient_mask(dx, dy, 0.1, 0.2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 5e-5 * np.abs(w).max()


def test_estimate_kernel_matches_jax(rng):
    # tests/test_ops.py's scene: a blocky 64x64 image blurred by a 9x9
    # Gaussian (sigma 1.2) through JAX's OTF.  The port's estimate at 1e-4 of
    # JAX's peak (float32 FFTs of another library after the saliency mask);
    # as JAX's, normalised, non-negative and peaked at the centre (7, 7)
    from galaxy_deconv_tpu import ops

    x = np.kron(rng.random((8, 8)).astype(np.float32) * 8, np.ones((8, 8), np.float32))
    otf = ops.psf_to_otf(ops.gauss_kernel(9, 1.2), (64, 64))
    y = np.asarray(ops.conv_fft(otf, jnp.asarray(x)[None])[0])
    got = T.estimate_kernel(torch.from_numpy(x), torch.from_numpy(y), lambda_l2=1e-3, ksize=15).numpy()
    want = np.asarray(J.estimate_kernel(jnp.asarray(x), jnp.asarray(y), lambda_l2=1e-3, ksize=15))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert abs(float(got.sum()) - 1) <= 1e-5 and got.min() >= 0
    assert np.unravel_index(got.argmax(), got.shape) == (7, 7)


def test_bayer_helpers_match_jax(rng):
    # placement and the green average, bit for bit; a mosaic read back into its planes returns the image
    img = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    mosaic = T.rgb_to_bayer(torch.from_numpy(img))
    np.testing.assert_array_equal(mosaic.numpy(), np.asarray(J.rgb_to_bayer(jnp.asarray(img))))
    planes = [mosaic[0::2, 0::2], mosaic[0::2, 1::2], mosaic[1::2, 0::2], mosaic[1::2, 1::2]]
    for switch in (False, True):
        got = T.rggb_to_rgb(planes, switch_rgb=switch).numpy()
        np.testing.assert_array_equal(got, np.asarray(J.rggb_to_rgb([jnp.asarray(p.numpy()) for p in planes],
                                                                    switch_rgb=switch)))
    np.testing.assert_array_equal(T.rggb_to_rgb(planes).numpy(), img)
