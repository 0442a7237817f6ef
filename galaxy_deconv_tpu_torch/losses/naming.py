"""Run naming and the loss factory (counterpart of ``galaxy_deconv_tpu/losses/naming.py``).

``get_model_name`` gives the reference's run names, e.g.
``Gaussian_PnP_ADMM_8iters_MultiScale``; checkpoints are named after them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from galaxy_deconv_tpu_torch.losses.best_ellipse import BestEllipseLoss
from galaxy_deconv_tpu_torch.losses.moments import MomentBasedLoss
from galaxy_deconv_tpu_torch.losses.multiscale import MultiScaleLoss, mse_loss
from galaxy_deconv_tpu_torch.losses.shape_constraint import ShapeConstraint


def get_model_name(
    method: str,
    loss: str,
    filter: str = "Laplacian",
    n_iters: int = 8,
    llh: str = "Gaussian",
    pnp: bool = True,
    remove_subnet: bool = False,
) -> str:
    if method == "Unrolled_ADMM":
        name = f"{llh}{'_PnP' if pnp else ''}_ADMM_{n_iters}iters{'_No_SubNet' if remove_subnet else ''}"
    elif method in ("Tikhonet", "ShapeNet"):
        name = f"{method}_{filter}"
    else:
        name = method
    if method != "ShapeNet":
        name = f"{name}_{loss}"
    return name


def build_loss(loss: str, fov_pixels: int = 48, **kwargs) -> Callable:
    """The loss named as on the reference's command line (reference
    ``train.py:58-74``)."""
    if loss == "MultiScale":
        return MultiScaleLoss(**kwargs)
    if loss == "MSE":
        return mse_loss
    if loss == "Shape":
        return ShapeConstraint(fov_pixels=fov_pixels, **kwargs)
    if loss == "BestEllipse":
        step = 0.025
        levels = tuple(np.arange(0.3, 0.7 + step, step))
        return BestEllipseLoss(ellipse_levels=kwargs.pop("ellipse_levels", levels), **kwargs)
    if loss == "MomentBasedLoss":
        return MomentBasedLoss(**kwargs)
    raise ValueError(f"unknown loss {loss!r}")
