"""Solvers by the harness's method names (counterpart of
``galaxy_deconv_tpu/models/registry.py``).

A name with an iteration suffix, ``Richard-Lucy(30)`` or
``Unrolled_ADMM_Gaussian(8)``, sets ``n_iters``.  The JAX package's other
names raise ``NotImplementedError`` naming the ROADMAP item that ports them;
a name neither package knows raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Any, Callable

from torch import nn

from galaxy_deconv_tpu_torch.models.richardson_lucy import RichardsonLucy
from galaxy_deconv_tpu_torch.models.simple import NoDeconv, Wiener
from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import UnrolledADMMGaussian

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "No_Deconv": NoDeconv,
    "FPFS": NoDeconv,  # shear measured on obs with the true PSF
    "Wiener": Wiener,
    "Richard-Lucy": RichardsonLucy,
    "Unrolled_ADMM_Gaussian": UnrolledADMMGaussian,
    "Unrolled_ADMM_Gaussian_Bounded": lambda **kw: UnrolledADMMGaussian(
        rho_bounds=kw.pop("rho_bounds", (0.1, 10.0)), **kw),
}

# the JAX registry's other names, and the ROADMAP Queue 1 item that ports each
_ZOO = "the rest of the zoo"
NOT_PORTED = {
    "Unrolled_ADMM": "the two-dual Unrolled_ADMM",
    "Tikhonet": _ZOO,
    "Tikhonet_Laplacian": _ZOO,
    "ShapeNet": _ZOO,
    "ADMMNet": _ZOO,
    "ADMMNet_scaled": _ZOO,
    "ADMMNet_fixed": _ZOO,
    "ResUNet": _ZOO,
}

_SUFFIX = re.compile(r"^(?P<base>.+)\((?P<n>\d+)\)$")


def build_model(name: str, **kwargs: Any) -> nn.Module:
    """Build a solver by harness name, e.g. ``Unrolled_ADMM_Gaussian(8)``;
    extra kwargs go to its constructor."""
    m = _SUFFIX.match(name)
    if m:
        name = m.group("base")
        kwargs.setdefault("n_iters", int(m.group("n")))
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue 1: {NOT_PORTED[name]})")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
