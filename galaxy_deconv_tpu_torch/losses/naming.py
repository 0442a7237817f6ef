"""Run naming and the loss factory (counterpart of ``galaxy_deconv_tpu/losses/naming.py``).

``get_model_name`` gives the reference's run names, e.g.
``Gaussian_PnP_ADMM_8iters_MultiScale``; checkpoints are named after them.
"""

from __future__ import annotations

from typing import Callable

from galaxy_deconv_tpu_torch.losses.multiscale import MultiScaleLoss, mse_loss

NOT_PORTED = ("Shape", "BestEllipse", "MomentBasedLoss")


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


def build_loss(loss: str, **kwargs) -> Callable:
    """The loss named as on the reference's command line."""
    if loss == "MultiScale":
        return MultiScaleLoss(**kwargs)
    if loss == "MSE":
        return mse_loss
    if loss in NOT_PORTED:
        raise ValueError(f"loss {loss!r} is not ported yet (ROADMAP Queue 1: the other losses)")
    raise ValueError(f"unknown loss {loss!r}")
