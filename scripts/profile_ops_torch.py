"""Per-component profile of the bench pipeline on the card (counterpart of
``scripts/profile_ops.py``).

The pipeline is ``bench.py``'s: the flagship UnrolledADMMGaussian(8) at full
width with seed-0 weights through ``pipeline.py``, on ``bench.py``'s stamps.
Each component is timed on the device by CUDA events:

  full       the bench pipeline (model forward + shear measurement)
  model      the solver's forward only
  shear      the measurement only
  denoiser8  8 sequential ResUNet passes (the convolutions, no FFT)
  denoiser1  one ResUNet pass
  fftpath_{fft,matmul}  spectra + Wiener init + 8 x (x-update + dual), the
             denoiser replaced by the identity (the FFT and pointwise work, 8
             launches of the solve kernel, no convolution), with either
             spectral transform of ``models/unrolled_admm_gaussian.py``
  conv_{s}x{s}x{c}  16 chained 3x3 convolutions at each ResUNet stage's
             (spatial, channels), their TFLOP/s from their FLOPs
  loop{n}    n calls of ``full`` queued with one synchronisation at the end

Each component but ``loop{n}`` is timed call by call: events around one
call, the device synchronised after it, the mean over ``--repeats`` calls
after a warm-up.  ``loop{n}`` lets the host queue the next call while the
device runs the last (the eager counterpart of JAX's on-device loop), so
``dispatch_overhead_ms`` = full - loop{n} is what a call pays for starting
from an idle device.

Writes ``--out`` with the card's name and power limit.

Usage: python scripts/profile_ops_torch.py [--batch 256] [--repeats 40] [--dtype bfloat16|float32] [--device cpu]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from galaxy_deconv_tpu_torch import bench  # noqa: E402
from galaxy_deconv_tpu_torch.metrics import estimate_shear  # noqa: E402
from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import gaussian_spectra, wiener_init, x_update  # noqa: E402
from galaxy_deconv_tpu_torch.nets import ResUNet  # noqa: E402
from galaxy_deconv_tpu_torch.pipeline import init_parameters  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import card_name_and_power_limit, fp32_only, resolve_device  # noqa: E402

FEATURES = (32, 64, 128, 256)
STAGES = ((48, 32), (24, 64), (12, 128), (6, 256))  # the ResUNet's (spatial, channels) per stage
N_CONV = 16  # chained convolutions per conv_ call: enough work to swamp the launches
LOOPS = (8,)


def fftpath(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor, impl: str = "fft", n_iters: int = 8) -> torch.Tensor:
    """The flagship's spectral work with the identity for its denoiser: the
    spectra, the Wiener init, then ``n_iters`` x-updates (rho 0.5) and dual
    updates."""
    y = y.clamp_min(0.0)
    shape = (y.shape[-2], y.shape[-1])
    Y, Ht, HtH = gaussian_spectra(y, p, impl)
    z = wiener_init(Y, Ht, HtH, a, shape, impl)
    u = torch.zeros_like(y)
    rho = torch.full((y.shape[0], 1, 1), 0.5, dtype=torch.float32, device=y.device)
    for _ in range(n_iters):
        x = x_update(Y, Ht, HtH, z, u, rho, shape, impl)
        z = x  # the identity "denoiser"
        u = u + rho * (x - z)
    return z


def components(pipe, obs, psf, alpha, dtype: torch.dtype) -> dict:
    """name -> (fn of no arguments, FLOPs per call or None)."""
    model, B = pipe.model, obs.shape[0]
    dn = ResUNet(features=FEATURES).to(dtype)
    init_parameters(dn, 0)
    dn = dn.to(obs.device).eval()
    x48 = obs[:, None].to(dtype)

    def denoiser8():
        x = x48
        for _ in range(8):
            x = dn(x)
        return x

    comps = {
        "full": (lambda: pipe(obs, psf, alpha), None),
        "model": (lambda: pipe.reconstruct(obs, psf, alpha), None),
        "shear": (lambda: estimate_shear(obs), None),
        "denoiser8": (denoiser8, None),
        "denoiser1": (lambda: dn(x48), None),
        "fftpath_fft": (lambda: fftpath(obs, psf, alpha, "fft", model.n_iters), None),
        "fftpath_matmul": (lambda: fftpath(obs, psf, alpha, "matmul", model.n_iters), None),
    }
    for s, c in STAGES:
        conv = nn.Conv2d(c, c, 3, padding=1, bias=False).to(obs.device, dtype)
        x = torch.zeros((B, c, s, s), dtype=dtype, device=obs.device)

        def conv_n(x=x, conv=conv):
            for _ in range(N_CONV):
                x = conv(x)
            return x

        comps[f"conv_{s}x{s}x{c}"] = (conv_n, N_CONV * 2 * B * s * s * 9 * c * c)
    return comps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_queued(fn, device: torch.device, n: int, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` rounds of ``n`` calls queued
    with one synchronisation at the end of each round, after a warm-up call:
    CUDA events around each round on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    total = 0.0
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            total += (time.perf_counter() - t0) * 1e3
    return total / (reps * n)


def profile(comps: dict, B: int, device: torch.device, repeats: int) -> dict:
    """Every component's ms per call and gal/s (and TFLOP/s where it has
    FLOPs), the queued loops, and the dispatch overhead."""
    timings = {}

    def entry(name, ms, flops=None, note=""):
        timings[name] = {"ms_per_call": ms, "gal_per_sec": B / ms * 1e3}
        if flops:
            timings[name]["tflops_per_sec"] = flops / (ms * 1e-3) / 1e12
        print(f"{name:16s} {ms:8.3f} ms  {B / ms * 1e3:10.0f} gal/s"
              + (f"  {timings[name]['tflops_per_sec']:6.1f} TF/s" if flops else "") + note)

    with torch.inference_mode(), fp32_only():
        for name, (fn, flops) in comps.items():
            entry(name, time_queued(fn, device, 1, repeats), flops)
        for n in LOOPS:
            entry(f"loop{n}", time_queued(comps["full"][0], device, n, max(repeats // n, 3)),
                  note=f"   (per call, {n} queued)")
    return {"timings_ms": timings, "gal_per_sec": {k: v["gal_per_sec"] for k, v in timings.items()},
            "dispatch_overhead_ms": timings["full"]["ms_per_call"] - timings[f"loop{LOOPS[0]}"]["ms_per_call"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--dtype", default="bfloat16", choices=list(bench.DTYPES))
    ap.add_argument("--out", default="figures/op_profile_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pipe = bench.bench_pipeline(args.dtype, device, features=FEATURES)
    obs, psf, alpha = (torch.as_tensor(a, device=device) for a in bench.bench_inputs(args.batch))
    report = {"batch": args.batch, "repeats": args.repeats, "dtype": args.dtype, "device": bench.describe(device),
              "card": card_name_and_power_limit() if device.type == "cuda" else None,
              "clock": "CUDA events" if device.type == "cuda" else "host"}
    report.update(profile(components(pipe, obs, psf, alpha, bench.DTYPES[args.dtype]), args.batch, device,
                          args.repeats))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
