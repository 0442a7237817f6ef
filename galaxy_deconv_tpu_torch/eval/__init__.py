"""Evaluation sweeps writing the reference's ``results.json`` schema
(counterpart of ``galaxy_deconv_tpu/eval``; the reference's ``test.py`` and
``test_psf.py``): each (method, SNR) cell is a few batched device calls, model
and shear measurement both on the device."""

from galaxy_deconv_tpu_torch.eval.harness import (
    DEFAULT_PSF_ERRS,
    make_apply_fn,
    median_ellipticity_error,
    run_psf_error_test,
    run_psnr_test,
    run_shear_test,
    run_time_test,
)

__all__ = [
    "DEFAULT_PSF_ERRS",
    "make_apply_fn",
    "median_ellipticity_error",
    "run_psf_error_test",
    "run_psnr_test",
    "run_shear_test",
    "run_time_test",
]
