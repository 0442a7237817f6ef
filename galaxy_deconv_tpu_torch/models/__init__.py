"""Solvers with the (obs, psf, alpha) -> rec contract on (B, H, W) stamps."""

from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import UnrolledADMMGaussian

__all__ = ["UnrolledADMMGaussian"]
