"""Solvers by the harness's method names (counterpart of
``galaxy_deconv_tpu/models/registry.py``): every name of the JAX package's
``MODEL_REGISTRY``, built the same way.

A name with an iteration suffix, ``Richard-Lucy(30)`` or
``Unrolled_ADMM(8)``, sets ``n_iters``; an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Any, Callable

from torch import nn

from galaxy_deconv_tpu_torch.models.admmnet import ADMMNet
from galaxy_deconv_tpu_torch.models.denoiser import ResUNetDenoiser
from galaxy_deconv_tpu_torch.models.richardson_lucy import RichardsonLucy
from galaxy_deconv_tpu_torch.models.simple import NoDeconv, Wiener
from galaxy_deconv_tpu_torch.models.tikhonet import Tikhonet
from galaxy_deconv_tpu_torch.models.unrolled_admm import UnrolledADMM
from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import UnrolledADMMGaussian

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "No_Deconv": NoDeconv,
    "FPFS": NoDeconv,  # shear measured on obs with the true PSF
    "Wiener": Wiener,
    "Richard-Lucy": RichardsonLucy,
    "Tikhonet": lambda **kw: Tikhonet(filter=kw.pop("filter", "Identity"), **kw),
    "Tikhonet_Laplacian": lambda **kw: Tikhonet(filter="Laplacian", **kw),
    "ShapeNet": lambda **kw: Tikhonet(filter="Laplacian", **kw),
    "Unrolled_ADMM": UnrolledADMM,
    "Unrolled_ADMM_Gaussian": UnrolledADMMGaussian,
    "Unrolled_ADMM_Gaussian_Bounded": lambda **kw: UnrolledADMMGaussian(
        rho_bounds=kw.pop("rho_bounds", (0.1, 10.0)), **kw),
    "ADMMNet": ADMMNet,
    # the denoiser fed inputs at its training scale (models/admmnet.py)
    "ADMMNet_scaled": lambda **kw: ADMMNet(denoiser_scale="adu", **kw),
    # the exact Poisson prox in place of the reference's wrong root
    "ADMMNet_fixed": lambda **kw: ADMMNet(poisson_prox="exact", **kw),
    "ResUNet": ResUNetDenoiser,
}

_SUFFIX = re.compile(r"^(?P<base>.+)\((?P<n>\d+)\)$")


def build_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a solver by harness name, e.g. ``Unrolled_ADMM_Gaussian(8)``;
    extra kwargs go to its constructor."""
    m = _SUFFIX.match(name)
    if m:
        name = m.group("base")
        kwargs.setdefault("n_iters", int(m.group("n")))
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
