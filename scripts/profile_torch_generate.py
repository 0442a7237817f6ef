"""Where the PyTorch port's simulator (``cli generate``) spends its device time.

    python3 scripts/profile_torch_generate.py

On one CUDA card at the default configuration (a pupil 512 samples across on
a 1024 FFT grid, 48x48 stamps drawn at 4x): one warm-up chunk, then
``CHUNKS`` chunks of ``CHUNK`` galaxies under ``torch.profiler``, first of
``simulate_batch`` (PSF, galaxy and observation, as the train and test splits
and every fixed-SNR variant render them), then of ``simulate_perturbed_psfs``
(the PSF alone, as each PSF-error set renders it).  Prints for each the wall
time per chunk, the device's busy time and idle share, the device time by
kernel class (FFT, the bilinear gather, reductions, elementwise) and the ten
most expensive kernels, and the peak device memory of one chunk.  Fails when
there is no card or the profiler records no device time.
"""

from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from galaxy_deconv_tpu_torch.data import simulate as sim  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import card_name_and_power_limit  # noqa: E402
from profile_torch_pipeline import profile  # noqa: E402

CHUNK = 256  # cli generate's default chunk
CHUNKS = 3
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("fft (cuFFT)", ("fft",)),
    ("gather (bilinear sample)", ("gather", "index")),
    ("reduction (sums, maxima)", ("reduce",)),
    ("copy (shifts, concatenation)", ("copy", "roll", "cat")),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_generate: no CUDA device is available", file=sys.stderr)
        return 1
    cfg = sim.SimulationConfig()
    print(f"card: {card_name_and_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}; pupil {cfg.pupil_n} on a "
          f"{cfg.pupil_pad} grid, {sim._sub_batch(cfg)} pupils per sub-batch, chunks of {CHUNK}")
    seeds = iter(range(1000))
    for label, fn in (("simulate_batch", lambda: sim.simulate_batch(next(seeds), CHUNK, cfg, "cuda")),
                      ("simulate_perturbed_psfs", lambda: sim.simulate_perturbed_psfs(next(seeds), CHUNK, cfg,
                                                                                    shear_err=0.05, device="cuda"))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profile(label, fn, CHUNKS, CHUNK, CLASSES)
        print(f"[{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
