"""Shear estimation and PSNR on (B, H, W) stamps: the batched FPFS estimator,
adaptive moments, the per-stamp numpy FPFS twin, PSNR, and the cross-checks
through the optional fpfs and ngmix packages (imported when called)."""

from galaxy_deconv_tpu_torch.metrics.adaptive_moments import (adaptive_moments, estimate_shear_adaptive,
                                                              estimate_shear_ngmix_reference)
from galaxy_deconv_tpu_torch.metrics.fpfs_numpy import estimate_shear_numpy, fpfs_moments_numpy
from galaxy_deconv_tpu_torch.metrics.psnr import psnr
from galaxy_deconv_tpu_torch.metrics.shear import (delta_psf, estimate_shear, estimate_shear_fpfs_reference,
                                                   fpfs_moments)

__all__ = ["adaptive_moments", "delta_psf", "estimate_shear", "estimate_shear_adaptive", "estimate_shear_fpfs_reference",
           "estimate_shear_ngmix_reference", "estimate_shear_numpy", "fpfs_moments", "fpfs_moments_numpy", "psnr"]
