"""Analysis and reporting (counterpart of ``galaxy_deconv_tpu/analysis``):
the reference's ``utils/utils_plot.py`` and ``figures/*.ipynb`` notebooks,
method colours and labels, loss curves, error against SNR and against PSF
error, and the paper's summary tables, all from the ``results.json`` schema
the evaluation harness writes."""

from galaxy_deconv_tpu_torch.analysis.report import (
    error_table,
    load_method_results,
    plot_error_vs_snr,
    plot_error_vs_time,
    plot_loss,
    plot_psf_error,
    plot_reconstruction_grid,
    plot_admm_trace,
    plot_batch_with_ellipses,
    psf_error_table,
    summarize_cis,
    summarize_psf_results,
    summarize_psnr_results,
    summarize_results,
)

__all__ = [
    "error_table",
    "load_method_results",
    "plot_error_vs_snr",
    "plot_error_vs_time",
    "plot_loss",
    "plot_psf_error",
    "plot_reconstruction_grid",
    "plot_admm_trace",
    "plot_batch_with_ellipses",
    "psf_error_table",
    "summarize_cis",
    "summarize_psf_results",
    "summarize_psnr_results",
    "summarize_results",
]
