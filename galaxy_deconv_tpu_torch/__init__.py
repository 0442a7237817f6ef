"""galaxy_deconv_tpu_torch — the PyTorch/CUDA port of galaxy_deconv_tpu.

The JAX package ``galaxy_deconv_tpu`` stays the reference; this package
mirrors its layout so each counterpart is easy to find:

- ``ops``      — Fourier helpers, the matmul-DFT spectra, resampling and edge
                 padding, and the x-update solve kernel and its backward
                 (``csrc/x_update_solve.cu``).
- ``nets``     — ResUNet, SubNet and their blocks as NCHW ``nn.Module``s.
- ``models``   — the flagship ``UnrolledADMMGaussian``, the Wiener,
                 Richardson-Lucy and identity baselines, ``build_model``.
- ``metrics``  — the batched FPFS shear estimator, PSNR.
- ``losses``   — MultiScale and MSE losses, run names.
- ``data``     — the LSST-like simulator on the device, the dataset
                 generator and the packed dataset's readers.
- ``train``    — train state, clipped Adam, checkpoints, the train loop.
- ``eval``     — the shear, time, PSF-error and PSNR sweeps.
- ``utils``    — the flax -> torch bridge (weights and train state), device
                 resolution, FLOP and byte counts.
- ``pipeline`` — model + shear measurement, the pipeline ``bench.py`` times.
- ``bench``    — the counterpart of ``bench.py`` and the MFU/roofline report.
- ``config``, ``cli`` — ``python -m galaxy_deconv_tpu_torch generate|train|test|bench ...``.

Public functions take the JAX layout, (B, H, W) stamps.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"`` (``--device cpu``).
Nothing here imports jax, flax, orbax or the JAX package.
"""

__version__ = "0.1.0"
