"""Where the PyTorch port's flagship spends its device time, serving and training.

    python3 scripts/profile_torch_pipeline.py

On one CUDA card, with TF32 off (the pipeline and the train step turn it
off themselves): for fp32 and bf16 nets, one warm-up call of the
pipeline (UnrolledADMMGaussian(8), full width, weights from seed 0, then the
shear estimate) at ``chip_smoke.py``'s batch, then ``FORWARDS`` calls under
``torch.profiler``; then one fp32 train step (MultiScale loss, clipped Adam)
at ``chip_smoke.py``'s training batch on its synthetic stamps, two warm-up
steps, then ``TRAIN_STEPS`` steps under the profiler.  Prints for each the
wall time per call, the device's busy time and idle share over the window,
the device time by kernel class, and the ten most expensive kernels.  Fails
when there is no card or the profiler records no device time.
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as profile_ctx

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import BATCH, TRAIN_BATCH, bench_inputs, card_line, galaxy_stamps  # noqa: E402
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss  # noqa: E402
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian  # noqa: E402
from galaxy_deconv_tpu_torch.pipeline import build_pipeline  # noqa: E402
from galaxy_deconv_tpu_torch.train import create_train_state, make_train_step  # noqa: E402

FORWARDS = 3
TRAIN_STEPS = 3
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("x_update_solve_backward (port kernel)", ("x_update_solve_backward",)),
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


def profile(label: str, fn, calls: int, B: int) -> None:
    """Run ``fn()`` ``calls`` times under the profiler (after the caller's
    warm-up) and print the breakdown per call."""
    torch.cuda.synchronize()
    with profile_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_class: dict[str, float] = {}
    for e in kernels:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total
    print(f"[{label}] B={B}, {calls} calls: wall {wall_s / calls * 1e3:.3f} ms/call "
          f"({calls * B / wall_s:.1f} gal/s under the profiler); device busy {busy_us / calls / 1e3:.3f} ms/call, "
          f"idle share {max(0.0, 1 - busy_us / 1e6 / wall_s):.3f}")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {cls:38s} {us / calls / 1e3:9.3f} ms/call  {us / busy_us:6.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{label}]     {e.self_device_time_total / calls / 1e3:8.3f} ms/call  x{e.count // calls:<4d} {e.key[:110]}")


def profile_dtype(dtype: torch.dtype) -> None:
    pipe = build_pipeline("cuda", dtype=dtype, seed=0)
    obs, psf, alpha = (torch.as_tensor(a, device="cuda") for a in bench_inputs(BATCH))
    pipe(obs, psf, alpha)
    profile(str(dtype).removeprefix("torch."), lambda: pipe(obs, psf, alpha), FORWARDS, BATCH)


def host_ms(fn, calls: int = 10) -> float:
    """Median host ms of ``fn()`` with the device synchronised before and after."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[calls // 2] * 1e3


def profile_train_step() -> None:
    model = UnrolledADMMGaussian().to("cuda")
    state, optimizer = create_train_state(model, 0)
    step = make_train_step(model, MultiScaleLoss(), optimizer)
    batch = galaxy_stamps(TRAIN_BATCH)
    for _ in range(2):
        step(state, batch)
    profile("train fp32", lambda: step(state, batch), TRAIN_STEPS, TRAIN_BATCH)
    grads = {n: p.grad for n, p in model.named_parameters()}
    print(f"[train fp32] host ms, device synchronised around each, median of 10: whole step "
          f"{host_ms(lambda: step(state, batch)):.3f}; ClippedAdam.update alone ({len(grads)} tensors) "
          f"{host_ms(lambda: optimizer.update(grads, state.opt_state)):.3f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off inside the "
          f"pipeline's calls and the train step")
    for dtype in (torch.float32, torch.bfloat16):
        profile_dtype(dtype)
    profile_train_step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
