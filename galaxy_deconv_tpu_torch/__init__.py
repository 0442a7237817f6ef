"""galaxy_deconv_tpu_torch — the PyTorch/CUDA port of galaxy_deconv_tpu.

The JAX package ``galaxy_deconv_tpu`` stays the reference; this package
mirrors its layout so each counterpart is easy to find:

- ``ops``      — Fourier helpers, the matmul-DFT spectra, edge padding, and
                 the x-update solve kernel (``csrc/x_update_solve.cu``).
- ``nets``     — ResUNet, SubNet and their blocks as NCHW ``nn.Module``s.
- ``models``   — the flagship ``UnrolledADMMGaussian``.
- ``metrics``  — the batched FPFS shear estimator.
- ``utils``    — the flax -> torch weight bridge and device resolution.
- ``pipeline`` — model + shear measurement, the counterpart of ``bench.py``.

Public functions take the JAX layout, (B, H, W) stamps.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.  Nothing here
imports jax, flax, orbax or the JAX package.
"""

__version__ = "0.1.0"
