"""Training losses: MultiScale, MSE, the shape constraint, best-ellipse and
moment losses, and the run-naming scheme."""

from galaxy_deconv_tpu_torch.losses.best_ellipse import BestEllipseLoss
from galaxy_deconv_tpu_torch.losses.moments import MomentBasedLoss
from galaxy_deconv_tpu_torch.losses.multiscale import MultiScaleLoss, l1_loss, mse_loss
from galaxy_deconv_tpu_torch.losses.naming import build_loss, get_model_name
from galaxy_deconv_tpu_torch.losses.shape_constraint import ShapeConstraint

__all__ = ["BestEllipseLoss", "MomentBasedLoss", "MultiScaleLoss", "ShapeConstraint", "build_loss",
           "get_model_name", "l1_loss", "mse_loss"]
