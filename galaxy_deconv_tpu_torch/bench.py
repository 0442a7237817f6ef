"""The port's headline benchmark (counterpart of the root ``bench.py``) and
its MFU/roofline report (counterpart of ``scripts/mfu.py``).

    python -m galaxy_deconv_tpu_torch.bench [--batch 256] [--repeats 40] [--quick]
        [--dtype bfloat16|float32] [--device cuda|cpu]
    python -m galaxy_deconv_tpu_torch bench [--batch_size 1024] [--repeats 10] ...

Times the flagship pipeline, ``UnrolledADMMGaussian(8)`` at full width
(features (32, 64, 128, 256), weights from seed 0) then ``estimate_shear``,
on ``bench.py``'s stamps, and prints ONE JSON line with ``bench.py``'s
schema:

    {"metric": "galaxies_per_sec_per_chip_admm8", "value": N,
     "unit": "gal/s/chip", "vs_baseline": N / (1 / 0.0590)}

The baseline is the reference's PyTorch pipeline at batch size 1 with the
CPU FPFS measurement, 0.0590 s per galaxy.  The nets run in ``--dtype``
(bfloat16 by default, as ``bench.py``); the spectra stay float32, and a
float32 run has TF32 off (``Pipeline``'s calls).  One warm-up call, then
``repeats`` calls timed on the host clock from a synchronised device to the
last result's copy to the host.  The device and the card's name go to
stderr.  Without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from galaxy_deconv_tpu_torch.pipeline import Pipeline, build_pipeline
from galaxy_deconv_tpu_torch.utils import flops

METRIC = "galaxies_per_sec_per_chip_admm8"
BASELINE_GAL_PER_SEC = 1.0 / 0.0590  # the reference's 8-iteration ADMM with its shear measurement
FLAGSHIP = {"n_iters": 8, "features": (32, 64, 128, 256)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bench_inputs(B: int, seed: int = 0):
    """The stamps ``bench.py`` times: |N(0,1)| * 20 obs, normalised |N| PSFs
    divided by 16, alpha 50, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    obs = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 20
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf = psf / psf.sum(axis=(1, 2), keepdims=True) / 16.0
    alpha = np.full((B,), 50.0, np.float32)
    return obs, psf, alpha


def bench_pipeline(dtype: str = "bfloat16", device="cuda", **model) -> Pipeline:
    """The pipeline ``bench.py`` times: the flagship (``model`` overrides its
    ``n_iters``/``features``) with seed-0 weights, nets in ``dtype``."""
    return build_pipeline(device, dtype=DTYPES[dtype], seed=0, **{**FLAGSHIP, **model})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(pipe: Pipeline, inputs, repeats: int) -> tuple[float, torch.Tensor]:
    """One warm-up call of ``pipe`` on ``inputs`` (uploaded once), then
    ``repeats`` calls: the seconds from a synchronised device to the last
    result on the host (calls queue on one stream, so that copy waits for
    all of them), and that last (B, 3) result."""
    if repeats < 1:
        raise ValueError(f"repeats must be at least 1, got {repeats}")
    obs, psf, alpha = (torch.as_tensor(a, device=pipe.device) for a in inputs)
    pipe(obs, psf, alpha)
    _sync(pipe.device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = pipe(obs, psf, alpha)
    out = out.cpu()
    return time.perf_counter() - t0, out


def describe(device: torch.device) -> str:
    return f"{device} ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else str(device)


def record(gal_per_sec: float) -> dict:
    """``bench.py``'s JSON line for a throughput."""
    return {"metric": METRIC, "value": round(gal_per_sec, 1), "unit": "gal/s/chip",
            "vs_baseline": round(gal_per_sec / BASELINE_GAL_PER_SEC, 1)}


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns its record."""
    parser = argparse.ArgumentParser(prog="galaxy_deconv_tpu_torch.bench")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--repeats", type=int, default=40)
    parser.add_argument("--quick", action="store_true", help="batch 64, 3 repeats")
    parser.add_argument("--dtype", default="bfloat16", choices=list(DTYPES),
                        help="the nets' compute type (the spectra stay float32)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quick:
        args.batch, args.repeats = 64, 3

    pipe = bench_pipeline(args.dtype, args.device)
    print(f"device: {describe(pipe.device)}", file=sys.stderr)
    seconds, _ = timed_run(pipe, bench_inputs(args.batch), args.repeats)
    print(f"{args.repeats} x {args.batch} galaxies in {seconds:.3f}s", file=sys.stderr)
    out = record(args.repeats * args.batch / seconds)
    print(json.dumps(out))
    return out


def mfu_report(batch: int = 256, repeats: int = 40, dtype: str = "bfloat16", device="cuda",
               gal_per_sec: float | None = None) -> dict:
    """The MFU/roofline report of the benchmark's pipeline (``scripts/mfu.py``'s
    counterpart) at ``batch`` on ``device``.

    One forward and shear measurement, counted by :func:`flops.measure`:
    FLOPs are the convolutions' and matmuls' that ``FlopCounterMode`` counts,
    per galaxy, held equal to the count from the layers' shapes; the ResUNet's
    share is that count within the model's ``resunet`` over its 8 calls.  The
    FFTs, the x-update solve and the elementwise work are not counted (XLA's
    ``cost_analysis`` behind ``scripts/mfu.py`` counted them too, so the
    fields whose meaning differs carry other names).  Bytes are every aten
    op's inputs and outputs, the solve kernel's operands on the card: the
    traffic if nothing fused, an upper bound.  Throughput is a
    :func:`timed_run` of ``repeats`` calls, or ``gal_per_sec`` when given.
    """
    pipe = bench_pipeline(dtype, device)
    obs, psf, alpha = (torch.as_tensor(a, device=pipe.device) for a in bench_inputs(batch))
    counts = flops.measure(pipe.model, pipe, obs, psf, alpha)
    counted, resunet = counts.flops, counts.analytic_flops_in("resunet")

    if gal_per_sec is None:
        seconds, _ = timed_run(pipe, (obs, psf, alpha), repeats)
        gal_per_sec, source = repeats * batch / seconds, "measured"
    else:
        source = "supplied"
    peak = flops.H100_PEAK_BF16 if dtype == "bfloat16" else flops.H100_PEAK_FP32
    per_gal = counted / batch
    tflops = gal_per_sec * per_gal / 1e12
    intensity = counted / counts.bytes
    knee = peak / flops.H100_HBM_BW
    return {
        "batch": batch,
        "dtype": dtype,
        "device": describe(pipe.device),
        "gal_per_sec": round(gal_per_sec, 1),
        "throughput_source": source,
        "flops_counted": "aten convolutions and matmuls (torch.utils.flop_counter.FlopCounterMode); "
                         "not the FFTs, the x-update solve or elementwise ops",
        "conv_matmul_flops_per_galaxy": round(per_gal),
        "analytic_flops_per_galaxy": round(counts.analytic_flops / batch),
        "flops_per_galaxy_by_op": {k: round(v / batch) for k, v in counts.flops_by_op.items()},
        "conv_flops_per_galaxy_8xResUNet": round(resunet / batch),
        "resunet_share_of_counted_flops": round(resunet / counted, 4),
        "sustained_model_tflops": round(tflops, 2),
        "peak_tflops_dtype_matched": round(peak / 1e12, 1),
        "mfu_vs_dtype_peak": round(tflops * 1e12 / peak, 4),
        "bytes_accessed_unfused_per_galaxy": round(counts.bytes / batch),
        "arithmetic_intensity_unfused_flop_per_byte": round(intensity, 1),
        "h100_roofline_knee_flop_per_byte": round(knee, 1),
        "hbm_bound_if_unfused": bool(intensity < knee),
    }


if __name__ == "__main__":
    main()
