"""Batched FPFS shear estimation on (B, H, W) stamps."""

from galaxy_deconv_tpu_torch.metrics.shear import delta_psf, estimate_shear, fpfs_moments

__all__ = ["delta_psf", "estimate_shear", "fpfs_moments"]
