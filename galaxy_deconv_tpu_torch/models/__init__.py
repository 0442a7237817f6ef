"""Solvers with the (obs, psf, alpha) -> rec contract on (B, H, W) stamps."""

from galaxy_deconv_tpu_torch.models.admmnet import ADMMNet
from galaxy_deconv_tpu_torch.models.denoiser import ResUNetDenoiser
from galaxy_deconv_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from galaxy_deconv_tpu_torch.models.richardson_lucy import RichardsonLucy
from galaxy_deconv_tpu_torch.models.simple import NoDeconv, Wiener
from galaxy_deconv_tpu_torch.models.tikhonet import Tikhonet
from galaxy_deconv_tpu_torch.models.unrolled_admm import UnrolledADMM
from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import UnrolledADMMGaussian

__all__ = ["ADMMNet", "MODEL_REGISTRY", "NoDeconv", "ResUNetDenoiser", "RichardsonLucy", "Tikhonet", "UnrolledADMM",
           "UnrolledADMMGaussian", "Wiener", "build_model"]
