"""Where the PyTorch port's flagship pipeline spends its device time.

    python3 scripts/profile_torch_pipeline.py

On one CUDA card, for fp32 (TF32 off) and bf16 nets: one warm-up call of the
pipeline (UnrolledADMMGaussian(8), full width, weights from seed 0, then the
shear estimate) at ``chip_smoke.py``'s batch, then ``FORWARDS`` calls under
``torch.profiler``.  Prints the wall time per call, the device's busy time and
idle share over the window, the device time by kernel class, and the ten most
expensive kernels.  Fails when there is no card or the profiler records no
device time.
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import BATCH, bench_inputs, card_line  # noqa: E402
from galaxy_deconv_tpu_torch.pipeline import build_pipeline  # noqa: E402

FORWARDS = 3
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("x_update_solve (port kernel)", ("x_update_solve",)),
    ("convolution", ("conv", "cudnn", "gemm", "xmma", "sm90_", "sm80_", "winograd", "implicit")),
    ("fft", ("fft", "vector_fft", "regular_fft")),
    ("batch norm / pooling", ("batch_norm", "max_pool", "pool")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise / other"


def profile_dtype(dtype: torch.dtype) -> None:
    B, forwards = BATCH, FORWARDS
    pipe = build_pipeline("cuda", dtype=dtype, seed=0)
    obs, psf, alpha = (torch.as_tensor(a, device="cuda") for a in bench_inputs(B))
    pipe(obs, psf, alpha)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            pipe(obs, psf, alpha)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_class: dict[str, float] = {}
    for e in kernels:
        label = kernel_class(e.key)
        by_class[label] = by_class.get(label, 0.0) + e.self_device_time_total
    name = str(dtype).removeprefix("torch.")
    print(f"[{name}] B={B}, {forwards} calls: wall {wall_s / forwards * 1e3:.3f} ms/call "
          f"({forwards * B / wall_s:.1f} gal/s under the profiler); device busy {busy_us / forwards / 1e3:.3f} ms/call, "
          f"idle share {max(0.0, 1 - busy_us / 1e6 / wall_s):.3f}")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[{name}]   {label:32s} {us / forwards / 1e3:9.3f} ms/call  {us / busy_us:6.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{name}]     {e.self_device_time_total / forwards / 1e3:8.3f} ms/call  x{e.count // forwards:<4d} {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
    for dtype in (torch.float32, torch.bfloat16):
        profile_dtype(dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
