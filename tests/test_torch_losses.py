"""Port parity: the shape-constraint, best-ellipse and moment losses and their
shearlet bank (galaxy_deconv_tpu_torch.losses) against the JAX package on the
same numpy inputs: 8 sheared elliptical-Gaussian stamps of 48 x 48
(``chip_smoke.galaxy_stamps``) against a copy perturbed by 5 % of each
stamp's peak.  Each test states its tolerance and the CPU's reading."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.losses import best_ellipse as jbe
from galaxy_deconv_tpu.losses import moments as jmoments
from galaxy_deconv_tpu.losses import naming as jnaming
from galaxy_deconv_tpu.losses import shape_constraint as jshape
from galaxy_deconv_tpu.losses import shearlets as jshearlets
from galaxy_deconv_tpu_torch.losses import (
    BestEllipseLoss,
    MomentBasedLoss,
    MultiScaleLoss,
    ShapeConstraint,
    best_ellipse,
    build_loss,
    moments,
    mse_loss,
    shape_constraint,
    shearlets,
)
from test_torch_online import one_thread  # noqa: F401  (autouse: one torch thread here too)

REPO = pathlib.Path(__file__).resolve().parent.parent
B = 8


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    gt = chip_smoke().galaxy_stamps(B, seed=11)["gt"]
    rng = np.random.default_rng(5)
    out = (gt + 0.05 * gt.max(axis=(1, 2), keepdims=True) * rng.standard_normal(gt.shape)).astype(np.float32)
    return out, gt


def port_value_and_grad(fn, out, gt):
    o = torch.tensor(out, requires_grad=True)
    value = fn(o, torch.tensor(gt))
    value.backward()
    return float(value.detach()), o.grad.numpy()


def jax_value_and_grad(fn, out, gt):
    value, grad = jax.jit(jax.value_and_grad(lambda o, t: fn(o, t)))(jnp.asarray(out), jnp.asarray(gt))
    return float(value), np.asarray(grad)


def rel_of_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- the shearlet bank and the shape constraint's constants -----------------------


@pytest.mark.parametrize("size,scales", [(48, 2), (32, 3)])
def test_shearlet_bank_matches_jax(size, scales):
    # the same numpy float64 construction: the Fourier masks bit for bit, the
    # spatial filters and a Parseval round trip to 1e-12
    bank = shearlets.shearlet_bank_fourier(size, size, scales)
    np.testing.assert_array_equal(bank, jshearlets.shearlet_bank_fourier(size, size, scales))
    np.testing.assert_allclose(shearlets.shearlet_spatial_filters(size, size, scales),
                               jshearlets.shearlet_spatial_filters(size, size, scales), rtol=0, atol=1e-12)
    img = np.random.default_rng(size).standard_normal((size, size))
    np.testing.assert_allclose(shearlets.synthesis(shearlets.analysis(img, scales), scales), img, atol=1e-12)
    np.testing.assert_allclose(shearlets.analysis(img, scales), jshearlets.analysis(img, scales), atol=1e-12)


@pytest.mark.parametrize("bank", [None, "dog"], ids=["shearlet", "dog"])
def test_compute_psu_mu_matches_jax(bank):
    # float32 constants, exactly equal; U and the DoG bank in float64 exactly
    psu, mu = shape_constraint.compute_psu_mu(48, 2, bank=bank)
    jpsu, jmu = jshape.compute_psu_mu(48, 2, bank=bank)
    assert psu.dtype == mu.dtype == np.float32 and psu.shape == (6, 17 if bank is None else 3, 48, 48)
    np.testing.assert_array_equal(psu, jpsu)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(shape_constraint.make_u(48, 40), jshape.make_u(48, 40))
    np.testing.assert_array_equal(shape_constraint._dog_filter_bank(48, 48, 2), jshape._dog_filter_bank(48, 48, 2))


def test_compute_psu_mu_requires_alpha_transform_as_jax_does():
    # neither machine has AlphaTransform: 'alpha' raises ImportError on both sides
    for mod in (shape_constraint, jshape):
        with pytest.raises(ImportError):
            mod.compute_psu_mu(48, 2, bank="alpha")


# --- the losses against JAX -------------------------------------------------------------


def test_shape_constraint_matches_jax(pair):
    # value at 1e-6 (reading 9.6e-8), input gradient at 1e-6 of its largest
    # entry (reading 7.7e-8): float32 sums over 8 x 102 x 48 x 48 products
    out, gt = pair
    got = port_value_and_grad(ShapeConstraint(), out, gt)
    want = jax_value_and_grad(jshape.ShapeConstraint(), out, gt)
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    assert rel_of_max(got[1], want[1]) <= 1e-6
    zero = ShapeConstraint()(torch.tensor(gt), torch.tensor(gt))
    assert float(zero) == 0.0 and float(ShapeConstraint()(torch.tensor(out), torch.tensor(gt))) >= \
        float(mse_loss(torch.tensor(out), torch.tensor(gt)))


def test_moments_and_loss_match_jax(pair):
    # Each moment of the port to its own float64 run within 1e-4 of the
    # field's largest entry (readings up to 5.4e-5, mu03; JAX's float32 moments
    # read up to 1.0e-4 against the same float64 run, mu30: sums of signed
    # d^3-weighted pixels cancel), so to JAX's within 2e-4 (reading 1.4e-5 on
    # mu11 to 7e-5); the ellipse parameters at 1e-4 (theta reads 1.9e-5: it
    # carries mu11's rounding); the loss at 1e-5
    # (reading 8.9e-7) and its gradient at 1e-4 of the largest entry (8.3e-6)
    out, gt = pair
    got, want = moments.compute_moments(torch.tensor(out)), jmoments.compute_moments(jnp.asarray(out))
    exact = moments.compute_moments(torch.tensor(out, dtype=torch.float64))
    assert got.keys() == want.keys()
    for k in got:
        assert rel_of_max(got[k].numpy(), exact[k].numpy()) <= 1e-4, k
        assert rel_of_max(got[k].numpy(), np.asarray(want[k])) <= 2e-4, k
    np.testing.assert_allclose(moments.ellipse_params_from_moments(torch.tensor(out)).numpy(),
                               np.asarray(jmoments.ellipse_params_from_moments(jnp.asarray(out))), rtol=1e-4,
                               atol=1e-4)
    got = port_value_and_grad(MomentBasedLoss(), out, gt)
    want = jax_value_and_grad(jmoments.MomentBasedLoss(), out, gt)
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    assert rel_of_max(got[1], want[1]) <= 1e-4


def jax_conics(images, levels, sharpness=0.1):
    """JAX's conics of each min-max normalised image at each level, (L, B, 6)."""
    x = jbe.min_max_normalize(jnp.asarray(images))
    pts = jnp.broadcast_to(jbe._grid_points(*images.shape[1:])[None], (images.shape[0], x[0].size, 2))
    fit = jax.jit(lambda p: jbe.weighted_ellipse_fit(pts, jbe.sigmoid_mask(x, p, sharpness).reshape(len(images), -1)))
    return np.stack([np.asarray(fit(jnp.float32(level))) for level in levels])


def test_best_ellipse_matches_jax(pair):
    """The 17 levels of build_loss.  Each conic is the SVD's last right
    singular vector, whose sign no solver fixes (LAPACK's on both sides
    here): the conics to JAX's up to sign, |c . c_jax| >= 1 - 1e-5 (reading
    1 - 6e-8); then the loss from the port's conics given JAX's signs, which
    is the port's own loss wherever the signs agree: value at 1e-5 (reading
    5.5e-7), input gradient, through the SVD, at 1e-3 of its largest entry
    (reading 1.1e-4: two LAPACKs' singular vectors differ in the last bits)."""
    out, gt = pair
    loss, jloss = build_loss("BestEllipse"), jnaming.build_loss("BestEllipse")
    assert tuple(loss.ellipse_levels) == tuple(jloss.ellipse_levels) and len(loss.ellipse_levels) == 17
    o, t = torch.tensor(out, requires_grad=True), torch.tensor(gt)
    conics = [loss.conics(o), loss.conics(t)]
    signs = []
    for c, x in zip(conics, (out, gt)):
        dot = (c.detach().numpy() * jax_conics(x, loss.ellipse_levels)).sum(-1)
        assert (1 - np.abs(dot)).max() <= 1e-5
        signs.append(torch.from_numpy(np.where(dot < 0, -1.0, 1.0).astype(np.float32)))
    value = loss.from_conics(t, *(c * s[..., None] for c, s in zip(conics, signs)))
    value.backward()
    value = float(value.detach())
    want = jax_value_and_grad(jloss, out, gt)
    assert abs(value - want[0]) <= 1e-5 * abs(want[0])
    assert rel_of_max(o.grad.numpy(), want[1]) <= 1e-3
    if all(bool((s > 0).all()) for s in signs):
        assert float(loss(torch.tensor(out), t)) == value


def blob(cy, cx, sy, sx, n=48):
    yy, xx = np.mgrid[:n, :n].astype(np.float32)
    return np.exp(-0.5 * (((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "round", "flat"])
def test_best_ellipse_gradient_stays_finite(case):
    """Degenerate masks (a round blob: a circle's conic; a flat image: one
    uniform mask) give near-repeated singular values; the gradient stays
    finite, as JAX's does on the same inputs (tests/test_losses.py::
    TestBestEllipse::test_grad_finite's blobs among them)."""
    tgt, out = {"blobs": (blob(24, 24, 6, 4), blob(25, 23, 5, 5)), "round": (blob(24, 24, 5, 5), blob(24, 24, 5, 5)),
                "flat": (np.ones((48, 48), np.float32), blob(24, 24, 5, 5))}[case]
    levels = (0.4, 0.5, 0.6)
    o = torch.tensor(out[None], requires_grad=True)
    value = BestEllipseLoss(ellipse_levels=levels)(o, torch.tensor(tgt[None]))
    value.backward()
    jgrad = jax.grad(lambda x: jbe.BestEllipseLoss(ellipse_levels=levels)(x, jnp.asarray(tgt[None])))(
        jnp.asarray(out[None]))
    assert np.isfinite(float(value.detach())) and torch.isfinite(o.grad).all()
    assert np.isfinite(np.asarray(jgrad)).all()


def test_best_ellipse_pieces_match_jax(pair):
    # conic_to_params, the fallback and the fit metric on the same conics at
    # 1e-5 (float32 algebra in another order)
    out, _ = pair
    c = jax_conics(out, (0.3, 0.5, 0.7))
    params = best_ellipse.ellipse_params(torch.from_numpy(c), 48, 48)
    want = np.asarray(jbe.conic_to_params(jnp.asarray(c)))
    np.testing.assert_allclose(params.numpy(), want, rtol=1e-5, atol=1e-5)
    bad = best_ellipse.ellipse_params(torch.full((2, 6), float("nan")), 48, 40)
    assert bad.tolist() == [[20.0, 24.0, 0.0, 10.0, 10.0]] * 2
    xn = jbe.min_max_normalize(jnp.asarray(out))
    np.testing.assert_allclose(
        best_ellipse.ellipse_fit_metric(best_ellipse.min_max_normalize(torch.tensor(out)), params).numpy(),
        np.stack([np.asarray(jbe.ellipse_fit_metric(xn, jnp.asarray(w))) for w in want]), rtol=1e-5, atol=1e-6)


# --- the factory ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MultiScale", "MSE", "Shape", "BestEllipse", "MomentBasedLoss"])
def test_build_loss_builds_every_name_as_jax(name):
    loss, jloss = build_loss(name), jnaming.build_loss(name)
    want = {"MultiScale": MultiScaleLoss, "Shape": ShapeConstraint, "BestEllipse": BestEllipseLoss,
            "MomentBasedLoss": MomentBasedLoss}
    if name == "MSE":
        assert loss is mse_loss and jloss.__name__ == "mse_loss"
    else:
        assert isinstance(loss, want[name]) and type(jloss).__name__ == want[name].__name__
    if name == "Shape":
        assert loss.psu.shape == (6, 17, 48, 48) and loss.gamma == jloss.gamma == 1.0
    if name == "BestEllipse":
        np.testing.assert_array_equal(np.asarray(loss.ellipse_levels), np.arange(0.3, 0.7 + 0.025, 0.025))
