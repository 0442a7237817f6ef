"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any fault raises and exits non-zero:

1. device    the card's name and power limit (nvidia-smi);
2. build     nvcc builds the kernel's CUDA source;
3. kernel    each kernel against its plain PyTorch version at the main
             path's shapes, and both timed with CUDA events around CUDA
             graph replays;
4. pipeline fp32   the flagship UnrolledADMMGaussian(8) + shear pipeline at
             full width, B = 256, weights from seed 0, TF32 off: finite, 8
             kernel launches per forward, and the first 8 galaxies against
             the same weights run on the CPU; the card's shear layer fed the
             CPU's reconstruction against the CPU's moments; and, as a
             control, a TF32 run that the reconstruction check must reject;
5. pipeline bf16   the same with bf16 nets: finite, its difference from
             fp32, and the gal/s of both dtypes.

The last three lines are the card's name and power limit, one JSON object
with each kernel's numbers, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from galaxy_deconv_tpu_torch.metrics.shear import estimate_shear, fpfs_moments
from galaxy_deconv_tpu_torch.ops import native
from galaxy_deconv_tpu_torch.ops import x_update as xu
from galaxy_deconv_tpu_torch.pipeline import build_pipeline

BATCH = 256
FLAGSHIP = {"n_iters": 8, "features": (32, 64, 128, 256)}
N_CPU_CHECK = 8
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM rate and fp32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_RTOL = KERNEL_ATOL = 1e-5  # as tests/test_pallas.py holds the TPU kernel
# CPU against card, fp32 with TF32 off: the convolutions sum in another order,
# and 8 unrolled iterations of a randomly initialised ResUNet amplify that.
# The same run with TF32 on must exceed it (the control in phase 4).
REC_REL_TOL = 1e-4  # max |rec_gpu - rec_cpu| / max |rec_cpu|
# g = e / R1E with R1E = (s0 - s4)/sqrt(2) + ...: on a random-weight
# reconstruction M40 ~ M00, so R1E nearly cancels and g amplifies the
# reconstruction's relative error about a thousandfold (on the CPU a 5e-6
# relative perturbation of rec moves g by 3.6e-3 (1 + |g|)).
SHEAR_TOL = 1e-2  # |g_gpu - g_cpu| <= SHEAR_TOL * (1 + |g_cpu|)
# The moments behind g are well conditioned: the card's shear layer, fed the
# CPU's reconstruction, holds each to max |m_gpu - m_cpu| / max |m_cpu|.
MOMENT_REL_TOL = 1e-4


def bench_inputs(B: int, seed: int = 0):
    """The stamps ``bench.py`` times: |N(0,1)| * 20 obs, normalised |N| PSFs, alpha 50."""
    rng = np.random.default_rng(seed)
    obs = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 20
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf = psf / psf.sum(axis=(1, 2), keepdims=True) / 16.0
    alpha = np.full((B,), 50.0, np.float32)
    return obs, psf, alpha


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _event_ms(fn, n: int) -> float:
    """ms per call over ``n`` calls of ``fn()``, each result dropped at once."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def eager_ms(fn, n: int) -> float:
    """ms per call of ``fn()`` launched from Python ``n`` times after a warm-up:
    device time, plus the gaps while the host launches when it is slower."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _event_ms(fn, n)


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device ms per call of ``fn()``: ``n`` calls captured in one CUDA graph,
    replayed ``replays`` times, so no host launch overhead is timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, replays) / n


def phase_build() -> None:
    t0 = time.perf_counter()
    lib, log = native.build("x_update_solve")
    ptxas = [ln.strip() for ln in log.splitlines() if "ptxas" in ln and ("Used" in ln or "spill" in ln)]
    print(f"build x_update_solve: nvcc {time.perf_counter() - t0:.2f} s -> {lib.name}; " + " | ".join(ptxas))


def phase_kernel_x_update_solve(device: torch.device, B: int = BATCH, n_iter: int = 200) -> dict:
    """The solve kernel against its plain version at the flagship's (B, 96, 49)."""
    shape = (B, 96, 49)
    rng = np.random.default_rng(1)

    def cplx():
        return torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                             torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).to(device)

    # four input sets (173 MB) in turn, so timed launches do not run from the 50 MB L2
    sets = []
    for _ in range(4):
        hth = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1).to(device)
        rho = torch.from_numpy(np.abs(rng.standard_normal(B)).astype(np.float32) + 0.1).to(device)
        sets.append((cplx(), cplx(), cplx(), hth, rho))

    got = xu.x_update_solve(*sets[0])
    want = xu.x_update_solve_plain(*sets[0])
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)

    turn = iter(range(10**9))
    wrapper_us = sorted(eager_ms(lambda: xu.x_update_solve(*sets[next(turn) % 4]), n_iter) * 1e3 for _ in range(5))
    ms = graph_ms(lambda: xu.x_update_solve(*sets[next(turn) % 4]), n_iter)
    plain_ms = graph_ms(lambda: xu.x_update_solve_plain(*sets[next(turn) % 4]), n_iter)
    n = got.numel()
    nbytes = sum(t.numel() * t.element_size() for t in sets[0]) + got.numel() * got.element_size()
    flops = 10 * n  # 4 mul + 4 add for Ht*Y + Z, 1 add + 1 reciprocal, 2 mul
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    print(f"kernel x_update_solve {shape}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); device time per call in a CUDA graph of {n_iter}: "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound {max(bytes_ms, flops_ms) * 1e3:.2f} us "
          f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.2f} MFLOP); wrapper launched from Python {n_iter} times: "
          f"median {wrapper_us[2]:.2f} us per call over 5 rounds ({wrapper_us[0]:.2f}-{wrapper_us[-1]:.2f})")
    return {"name": "x_update_solve", "route": "cuda",
            "source": "galaxy_deconv_tpu_torch/csrc/x_update_solve.cu",
            "replaces": "galaxy_deconv_tpu/ops/pallas_kernels.py:56",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms), "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def run_pipeline(device, dtype, inputs, n_iters, features, repeats: int = 0) -> dict:
    """One counted forward (+ shear) of the pipeline, then ``repeats`` timed ones."""
    pipe = build_pipeline(device, dtype=dtype, seed=0, n_iters=n_iters, features=features)
    obs, psf, alpha = inputs
    B = obs.shape[0]
    pipe(obs, psf, alpha)  # warm-up (cuDNN algorithm choice, FFT plans)
    if device.type == "cuda":
        torch.cuda.synchronize()
    xu.x_update_solve.launches = 0
    rec = pipe.reconstruct(obs, psf, alpha)
    shear = estimate_shear(rec)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = xu.x_update_solve.launches
    gal_per_s = None
    if repeats:
        t0 = time.perf_counter()
        for _ in range(repeats):
            pipe(obs, psf, alpha)
        torch.cuda.synchronize()
        gal_per_s = repeats * B / (time.perf_counter() - t0)
    rec, shear = rec.float().cpu(), shear.cpu()
    if rec.shape != (B, 48, 48) or shear.shape != (B, 3):
        raise AssertionError(f"pipeline shapes {tuple(rec.shape)}, {tuple(shear.shape)}")
    if not (torch.isfinite(rec).all() and torch.isfinite(shear).all()):
        raise AssertionError("pipeline output is not finite")
    return {"rec": rec, "shear": shear, "launches": launches, "gal_per_s": gal_per_s}


def check_launches(device, result, n_iters) -> None:
    """On the card, the x-update kernel ran once per unrolled iteration."""
    want = n_iters if device.type == "cuda" else 0
    if result["launches"] != want:
        raise AssertionError(f"x_update_solve launched {result['launches']} times in one forward, expected {want}")


def phase_pipeline_fp32(device, B=BATCH, n_iters=FLAGSHIP["n_iters"], features=FLAGSHIP["features"],
                        n_check=N_CPU_CHECK, repeats=0) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("pipeline fp32: torch.backends.cudnn.allow_tf32=False, torch.backends.cuda.matmul.allow_tf32=False")
    inputs = bench_inputs(B)
    res = run_pipeline(device, torch.float32, inputs, n_iters, features, repeats)
    check_launches(device, res, n_iters)
    ref = run_pipeline(torch.device("cpu"), torch.float32, [a[:n_check] for a in inputs], n_iters, features)
    rec, shear = res["rec"][:n_check], res["shear"][:n_check]
    rec_rel = float((rec - ref["rec"]).abs().max() / ref["rec"].abs().max())
    shear_err = float(((shear - ref["shear"]).abs() / (1 + ref["shear"].abs())).max())
    print(f"pipeline fp32: B={B} n_iters={n_iters} features={tuple(features)}: finite; x_update_solve launches "
          f"per forward {res['launches']}; first {n_check} vs CPU: rec max rel err {rec_rel:.3e} "
          f"(tol {REC_REL_TOL}), shear max err/(1+|g|) {shear_err:.3e} (tol {SHEAR_TOL})")
    if not (rec_rel <= REC_REL_TOL and shear_err <= SHEAR_TOL):
        raise AssertionError("card and CPU disagree")

    want = fpfs_moments(ref["rec"])
    got = {k: m.cpu() for k, m in fpfs_moments(ref["rec"].to(device)).items()}
    moment_rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in want}
    g_err = float(((estimate_shear(ref["rec"].to(device)).cpu() - ref["shear"]).abs() / (1 + ref["shear"].abs())).max())
    print(f"pipeline fp32: shear layer on {device.type} fed the CPU's reconstruction: moments max rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in moment_rel.items())
          + f" (tol {MOMENT_REL_TOL}); g err/(1+|g|) {g_err:.3e}")
    if max(moment_rel.values()) > MOMENT_REL_TOL:
        raise AssertionError("the card's shear moments disagree with the CPU's")

    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = run_pipeline(device, torch.float32, [a[:n_check] for a in inputs], n_iters, features)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        tf32_rel = float((tf32["rec"] - ref["rec"]).abs().max() / ref["rec"].abs().max())
        print(f"pipeline fp32 control: TF32 on, first {n_check} vs CPU: rec max rel err {tf32_rel:.3e} "
              f"(must exceed the tol {REC_REL_TOL})")
        if tf32_rel <= REC_REL_TOL:
            raise AssertionError("the reconstruction check cannot tell a TF32 run from an fp32 one")
    return res


def phase_pipeline_bf16(device, fp32: dict, B=BATCH, n_iters=FLAGSHIP["n_iters"], features=FLAGSHIP["features"],
                        repeats=0) -> dict:
    res = run_pipeline(device, torch.bfloat16, bench_inputs(B), n_iters, features, repeats)
    check_launches(device, res, n_iters)
    rec_rel = float((res["rec"] - fp32["rec"]).abs().max() / fp32["rec"].abs().max())
    shear_diff = float((res["shear"] - fp32["shear"]).abs().max())
    print(f"pipeline bf16: finite; x_update_solve launches per forward {res['launches']}; vs fp32: "
          f"rec max rel diff {rec_rel:.3e}, shear max abs diff {shear_diff:.3e}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; count {torch.cuda.device_count()}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    kernel = phase_kernel_x_update_solve(device)

    fp32 = phase_pipeline_fp32(device, repeats=10)
    kernel["launches"] = fp32["launches"]  # the main path's run: one fp32 forward
    bf16 = phase_pipeline_bf16(device, fp32, repeats=10)
    print(f"throughput ({card}): fp32 {fp32['gal_per_s']:.1f} gal/s, bf16 {bf16['gal_per_s']:.1f} gal/s "
          f"(B={BATCH}, 10 forwards + shear each, host clock around torch.cuda.synchronize())")

    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
