"""Training losses: MultiScale, MSE, and the run-naming scheme."""

from galaxy_deconv_tpu_torch.losses.multiscale import MultiScaleLoss, l1_loss, mse_loss
from galaxy_deconv_tpu_torch.losses.naming import build_loss, get_model_name

__all__ = ["MultiScaleLoss", "build_loss", "get_model_name", "l1_loss", "mse_loss"]
