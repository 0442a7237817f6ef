"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any fault raises and exits non-zero:

1. device    the card's name and power limit (nvidia-smi);
2. build     nvcc builds the kernels' CUDA source (the solve and its
             backward, one library);
3. kernel    each kernel against its plain PyTorch version at the main
             paths' shapes (the solve at the pipeline's B = 256; its
             backward at (1, 96, 49), the odd (3, 5, 7), the trainer's
             (32, 96, 49) and (256, 96, 49): bit-identical over two calls
             and under CUDA graph replay, and every forced number of blocks
             per galaxy at B = 32 and 256), and both timed with CUDA events
             around CUDA graph replays;
4. pipeline fp32   the flagship UnrolledADMMGaussian(8) + shear pipeline at
             full width, B = 256, weights from seed 0, with torch's default
             TF32 flags (the pipeline turns TF32 off itself): finite, 8
             kernel launches per forward, and the first 8 galaxies against
             the same weights run on the CPU; the card's shear layer fed the
             CPU's reconstruction against the CPU's moments; and, as a
             control, the model called directly with TF32 on, which the
             reconstruction check must reject;
5. pipeline bf16   the same with bf16 nets: finite, its difference from
             fp32, and the gal/s of both dtypes;
6. train fp32   a packed dataset of 320 synthetic stamps written from numpy
             seed 0, then (a) ``galaxy_deconv_tpu_torch.cli train`` for one
             epoch at full width, B = 32: finite losses, 8 forward and 8
             backward solve launches per train step, and its checkpoint
             restoring bit for bit; (b) one train step on 8 galaxies on the
             card and on the CPU from the same weights: loss and gradients,
             and a control, the same forward, loss and backward run outside
             the train step with TF32 on, that the gradient check must
             reject; (c) 20 steps on one batch, whose
             loss must fall; (d) train-step ms and gal/s at B = 32.

The last three lines are the card's name and power limit, one JSON object
with each kernel's numbers, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import FIELDS, GalaxyDataset, train_val_indices
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss, get_model_name
from galaxy_deconv_tpu_torch.metrics.shear import estimate_shear, fpfs_moments
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.ops import native
from galaxy_deconv_tpu_torch.ops import x_update as xu
from galaxy_deconv_tpu_torch.pipeline import build_pipeline
from galaxy_deconv_tpu_torch.train import create_train_state, make_train_step, restore_checkpoint
from galaxy_deconv_tpu_torch.train.checkpoint import state_payload

BATCH = 256
TRAIN_BATCH = 32  # config.py's default batch
N_STAMPS = 320  # 9 train steps of 32 at train_val_split 0.9, and one val batch
FLAGSHIP = {"n_iters": 8, "features": (32, 64, 128, 256)}
N_CPU_CHECK = 8
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM rate and fp32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_RTOL = KERNEL_ATOL = 1e-5  # as tests/test_pallas.py holds the TPU kernel
# grad_rho sums 4,704 terms of either sign per galaxy, so float32 rounding in
# any order moves it by ~1e-8 of the sum of the terms' magnitudes, which can
# be far above 1e-5 of the (cancelled) result; one term dropped moves it by
# ~1e-4 of that sum.  The kernel's and the fp32 plain version's grad_rho are
# held to the plain version in float64 at this share of that sum.
GRAD_RHO_TOL = 1e-6
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
# One train step, card against CPU, fp32 with TF32 off: the loss, and each
# parameter's gradient to max |g_gpu - g_cpu| / max |g_cpu|.  The SubNet's conv
# biases feed train-mode BatchNorm, which subtracts their effect: their exact
# gradient is 0 and both sides hold rounding noise, so they are held instead
# to max |g| / (the model's largest gradient).  Loss readings on an H100
# (NVIDIA H100 80GB HBM3, 700 W): 1.66e-6, 8.3e-7; zero-gradient biases 1e-6
# to 4e-6.  The worst gradient is nearly always a ResBlock's conv0 weight,
# whose gradient goes through ReLU's step-shaped derivative, so fp32 rounding
# that moves a pre-activation across 0 moves it by a jump.  Over weight seeds
# 0-7 (scripts/gradient_rounding.py, same H100): the CPU's step against its
# own step on observations one ulp apart 2.8e-4 to 1.03e-2, the card's fp32
# step against the CPU 1.2e-3 to 7.2e-3 (seed 0: 7.18e-3), and with TF32 on
# 1.45e-2 to 1.58e-1 (seed 0: 1.58e-1).  The limit sits between the largest
# fp32 reading and the smallest TF32 reading of all eight draws.
LOSS_REL_TOL = 1e-5
ZERO_GRAD_TOL = 1e-3
GRAD_REL_TOL = 1.2e-2


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
        return _cplx(rng, shape, device)

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


def _cplx(rng, shape, device):
    return torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                         torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).to(device)


BACKWARD_SHAPES = ((1, 96, 49), (3, 5, 7), (TRAIN_BATCH, 96, 49), (BATCH, 96, 49))
SPLITS = (1, 2, 4, 8)  # the blocks per galaxy the backward kernel can launch


def _backward_library(name: str, argtypes: list):
    fn = getattr(native.load("x_update_solve"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def backward_splits(G: torch.Tensor) -> int:
    """The blocks per galaxy that the backward kernel's launcher picks for G's shape on this card."""
    S = _backward_library("x_update_solve_backward_splits", [ctypes.c_longlong, ctypes.c_int])(G[0].numel(), G.shape[0])
    if S == 0:
        raise RuntimeError("x_update_solve_backward_splits: the device could not be queried")
    return S


def backward_at_splits(S: int, G, X, HtH, rho):
    """The backward kernel at a forced S blocks per galaxy, for measurement: it
    counts no launch."""
    grad_Z, grad_rho = torch.empty_like(G), torch.empty_like(rho)
    fn = _backward_library("x_update_solve_backward_at", [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                                                                 ctypes.c_int, ctypes.c_void_p])
    rc = fn(*(t.data_ptr() for t in (G, X, HtH, rho, grad_Z, grad_rho)), G[0].numel(), G.shape[0], S,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"x_update_solve_backward_at(S={S}): kernel launch failed with CUDA error {rc}")
    return grad_Z, grad_rho


def check_backward(name: str, fn, args, want, exact, scale) -> tuple[float, float]:
    """``fn(*args)`` against the plain version: grad_Z at KERNEL_RTOL/ATOL,
    grad_rho at GRAD_RHO_TOL of its terms' magnitudes against float64, two
    calls bit for bit.  Returns (max_abs_err over both outputs, grad_rho's error)."""
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    torch.testing.assert_close(got[0], want[0], rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    rho_err = float(((got[1].double() - exact).abs() / scale).max())
    if rho_err > GRAD_RHO_TOL:
        raise AssertionError(f"{name}: grad_rho off by {rho_err:.3e} of its terms' magnitudes")
    return max(float((g - w).abs().max()) for g, w in zip(got, want)), rho_err


def phase_kernel_x_update_solve_backward(device: torch.device, card: str, shapes=BACKWARD_SHAPES,
                                         n_iter: int = 200) -> dict:
    """The backward kernel against its plain version at ``shapes``: the
    wrapper, its replay in a CUDA graph, and at B = 32 and 256 every forced S;
    the entry of the trainer's (32, 96, 49)."""
    rng = np.random.default_rng(2)
    entry = None
    for shape in shapes:
        B, n = shape[0], int(np.prod(shape))
        nbytes = 28 * n + 8 * B  # read G, X (8 B each), HtH (4 B), rho; write grad_Z (8 B), grad_rho
        # input sets in turn (>= 150 MB, at most 64 sets) so that timed launches at the main
        # paths' shapes do not run from the 50 MB L2; the tiny shapes stay in it
        sets = []
        for _ in range(min(64, max(4, -(-150_000_000 // nbytes)))):
            hth = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1).to(device)
            rho = torch.from_numpy(np.abs(rng.standard_normal(B)).astype(np.float32) + 0.1).to(device)
            sets.append((_cplx(rng, shape, device), _cplx(rng, shape, device), hth, rho))
        G, X, hth, rho = sets[0]
        want = xu.x_update_solve_backward_plain(*sets[0])
        exact = xu.x_update_solve_backward_plain(*(t.to(torch.complex128 if t.is_complex() else torch.float64)
                                                   for t in sets[0]))[1]
        dims = tuple(range(1, G.ndim))
        scale = (((G.real * X.real).abs() + (G.imag * X.imag).abs()) / (rho.reshape(-1, *[1] * len(dims)) + hth))
        scale = scale.sum(dim=dims).double()
        plain_rho_err = float(((want[1].double() - exact).abs() / scale).max())
        max_abs, rho_err = check_backward("x_update_solve_backward", xu.x_update_solve_backward, sets[0], want,
                                          exact, scale)

        # the wrapper captured in a CUDA graph and replayed gives the eager call's bits
        eager = xu.x_update_solve_backward(*sets[0])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = xu.x_update_solve_backward(*sets[0])
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(eager, captured)):
            raise AssertionError("x_update_solve_backward: the CUDA graph's replay differs from the eager call")

        turn = iter(range(10**9))
        ms = graph_ms(lambda: xu.x_update_solve_backward(*sets[next(turn) % len(sets)]), n_iter)
        plain_ms = graph_ms(lambda: xu.x_update_solve_backward_plain(*sets[next(turn) % len(sets)]), n_iter)
        flops = 9 * n  # d, reciprocal, 2 mul for grad_Z, 3 mul + 2 add for the rho term
        bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        print(f"kernel x_update_solve_backward {shape} ({card}): S={backward_splits(G)} blocks per galaxy; "
              f"max_abs_err {max_abs:.3e} against the plain version; grad_Z within rtol {KERNEL_RTOL}, atol "
              f"{KERNEL_ATOL}; grad_rho against the plain version in float64: {rho_err:.3e} of the sum of its "
              f"terms' magnitudes (tol {GRAD_RHO_TOL}; the fp32 plain version: {plain_rho_err:.3e}); two calls and "
              f"a CUDA graph replay bit-identical; device time per call in a CUDA graph of {n_iter} over "
              f"{len(sets)} input sets: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {flops / 1e6:.2f} MFLOP)")

        if B in (TRAIN_BATCH, BATCH) and shape[1:] == (96, 49):
            sweep = []
            for S in SPLITS:
                def at_s(*args, S=S):
                    return backward_at_splits(S, *args)
                check_backward(f"x_update_solve_backward_at(S={S})", at_s, sets[0], want, exact, scale)
                sweep.append(f"S={S} {graph_ms(lambda: at_s(*sets[next(turn) % len(sets)]), n_iter) * 1e3:.2f} us")
            print(f"kernel x_update_solve_backward {shape} ({card}): forced blocks per galaxy, each checked as "
                  f"above, device time per call in a CUDA graph of {n_iter}: " + ", ".join(sweep)
                  + f"; bound {bound_ms * 1e3:.2f} us")
        if B == TRAIN_BATCH:
            entry = {"name": "x_update_solve_backward", "route": "cuda",
                     "source": "galaxy_deconv_tpu_torch/csrc/x_update_solve.cu",
                     "replaces": "galaxy_deconv_tpu/ops/pallas_kernels.py:56",
                     "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                     "library_ms": None}
    return entry


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
    print(f"pipeline fp32: the caller's flags, torch's defaults: torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
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
        # the control bypasses Pipeline, whose calls turn TF32 off
        pipe = build_pipeline(device, dtype=torch.float32, seed=0, n_iters=n_iters, features=features)
        obs, psf, alpha = (torch.as_tensor(a[:n_check], device=device) for a in inputs)
        with tf32_on(), torch.inference_mode():
            tf32_rec = pipe.model(obs, psf, alpha).cpu()
        tf32_rel = float((tf32_rec - ref["rec"]).abs().max() / ref["rec"].abs().max())
        print(f"pipeline fp32 control: the model called directly with TF32 on, first {n_check} vs CPU: rec max "
              f"rel err {tf32_rel:.3e} (must exceed the tol {REC_REL_TOL})")
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


def galaxy_stamps(n: int, seed: int = 0, size: int = 48) -> dict:
    """``n`` synthetic stamps in the packed dataset's fields, from numpy ``seed``:
    sheared elliptical Gaussian galaxies (gt), convolved with elliptical
    Gaussian PSFs normalised to sum 1, plus Gaussian noise at an SNR of 20-200
    (SNR = sqrt(sum clean^2) / sigma)."""
    rng = np.random.default_rng(seed)
    yy, xx = (np.mgrid[:size, :size] - size // 2).astype(np.float64)

    def gaussians(sigma, e1, e2):
        # exp(-r^T C^-1 r / 2) with covariance C = sigma^2 [[1 + e1, e2], [e2, 1 - e1]]
        s2 = sigma[:, None, None] ** 2
        a, b, c = s2 * (1 + e1[:, None, None]), s2 * e2[:, None, None], s2 * (1 - e1[:, None, None])
        det = a * c - b * b
        return np.exp(-0.5 * (c * xx**2 - 2 * b * xx * yy + a * yy**2) / det)

    g1, g2 = rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n)
    gal = gaussians(rng.uniform(1.5, 4.0, n), rng.uniform(-0.3, 0.3, n) + 2 * g1, rng.uniform(-0.3, 0.3, n) + 2 * g2)
    gt = gal / gal.sum(axis=(1, 2), keepdims=True) * rng.uniform(1e3, 1e4, n)[:, None, None]
    psf = gaussians(rng.uniform(1.0, 2.0, n), rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n))
    psf /= psf.sum(axis=(1, 2), keepdims=True)
    clean = np.fft.irfft2(np.fft.rfft2(gt) * np.fft.rfft2(np.fft.ifftshift(psf, axes=(1, 2))), s=(size, size))
    snr = rng.uniform(20, 200, n)
    sigma = np.sqrt((clean**2).sum(axis=(1, 2))) / snr
    obs = clean + rng.standard_normal(clean.shape) * sigma[:, None, None]
    out = {"obs": obs, "psf": psf, "gt": gt, "alpha": obs.mean(axis=(1, 2)), "snr": snr, "gal_g1": g1, "gal_g2": g2}
    return {k: out[k].astype(np.float32) for k in FIELDS}


def write_dataset(root: pathlib.Path, n: int = N_STAMPS, seed: int = 0) -> pathlib.Path:
    """A packed dataset (``data/dataset.py``'s layout) of :func:`galaxy_stamps`."""
    (root / "train").mkdir(parents=True, exist_ok=True)
    for name, arr in galaxy_stamps(n, seed).items():
        np.save(root / "train" / f"{name}.npy", arr)
    (root / "info.json").write_text(json.dumps({"n_train": n, "seed": seed, "source": "chip_smoke.galaxy_stamps"}))
    return root


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def one_train_step(device, batch, n_iters, features, seed: int = 0, tf32: bool = False):
    """One train step of a fresh model (weights from ``seed``): its loss and
    its gradients, on the CPU.  With ``tf32`` the same forward, loss and
    backward run outside ``make_train_step`` (whose step turns TF32 off), with
    TF32 on."""
    model = UnrolledADMMGaussian(n_iters=n_iters, features=features).to(device)
    state, optimizer = create_train_state(model, seed)
    if tf32:
        obs, psf, alpha, gt = (torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32, device=device)
                               for k in ("obs", "psf", "alpha", "gt"))
        model.train()
        with tf32_on():
            loss = MultiScaleLoss()(gt, model(obs, psf, alpha))
            loss.backward()
    else:
        state, loss = make_train_step(model, MultiScaleLoss(), optimizer)(state, batch)
    _sync(device)
    return float(loss.detach()), {n: p.grad.cpu() for n, p in model.named_parameters()}


@contextlib.contextmanager
def tf32_on():
    """TF32 on for cuDNN convolutions and CUDA matmuls inside the block; the flags restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _zero_grad_param(name: str) -> bool:
    """The SubNet's conv biases, which feed train-mode BatchNorm: exact gradient 0."""
    return re.fullmatch(r"subnet\.convs\.\d+\.conv\d\.bias", name) is not None


def grad_errors(loss, grads, ref_loss, ref_grads) -> tuple[float, float, str, float]:
    """(loss rel err, worst per-parameter gradient rel err and that parameter,
    zero-gradient biases' share of the largest gradient)."""
    rel = {n: float((grads[n] - g).abs().max() / g.abs().max()) for n, g in ref_grads.items()
           if not _zero_grad_param(n)}
    worst = max(rel, key=rel.get)
    top = max(float(g.abs().max()) for g in ref_grads.values())
    zero = max([float(grads[n].abs().max()) / top for n in ref_grads if _zero_grad_param(n)], default=0.0)
    return abs(loss - ref_loss) / abs(ref_loss), rel[worst], worst, zero


def phase_train_fp32(device, B=TRAIN_BATCH, n_stamps=N_STAMPS, n_iters=FLAGSHIP["n_iters"],
                     features=FLAGSHIP["features"], n_check=N_CPU_CHECK, n_steps=20, n_warm=5) -> dict:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = write_dataset(pathlib.Path(tmp) / "data", n_stamps)
        save = pathlib.Path(tmp) / "models"
        ds = GalaxyDataset(root)

        # (a) the command line, one epoch at full width
        xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
        state, hist = cli.main(["train", "--data_path", str(root), "--model_save_path", str(save), "--n_epochs", "1",
                                "--batch_size", str(B), "--n_iters", str(n_iters), "--seed", "0",
                                "--device", device.type])
        _sync(device)
        fwd, bwd = xu.x_update_solve.launches, xu.x_update_solve_backward.launches
        tr_idx, va_idx = train_val_indices(n_stamps, 0.9, 0)
        steps, val_batches = len(tr_idx) // B, -(-len(va_idx) // B)
        losses = hist["train_loss"] + hist["val_loss"]
        print(f"train fp32 (a): cli train, {n_stamps} stamps, B={B}, n_iters={n_iters}, full width: {state.step} "
              f"steps, train_loss {hist['train_loss'][0]:.6g}, val_loss {hist['val_loss'][0]:.6g}; solve launches "
              f"forward {fwd}, backward {bwd} ({val_batches} val batches)")
        if state.step != steps or not np.isfinite(losses).all():
            raise AssertionError(f"cli train took {state.step} steps (expected {steps}) with losses {losses}")
        want = (n_iters * (steps + val_batches), n_iters * steps) if device.type == "cuda" else (0, 0)
        if (fwd, bwd) != want:
            raise AssertionError(f"solve launches forward {fwd}, backward {bwd}; expected {want}: "
                                 f"{n_iters} + {n_iters} per train step, {n_iters} per val forward")
        restored = restore_checkpoint(save, get_model_name("Unrolled_ADMM", "MultiScale", n_iters=n_iters), 1)
        trained = state_payload(state)
        pairs = [(trained["model"][k], restored["model"][k]) for k in trained["model"]]
        pairs += [(trained["opt_state"][m][k], restored["opt_state"][m][k]) for m in ("mu", "nu")
                  for k in trained["opt_state"][m]]
        exact = all(torch.equal(a.cpu(), b) for a, b in pairs) and restored["step"] == state.step \
            and restored["opt_state"]["count"] == trained["opt_state"]["count"]
        print(f"train fp32 (a): checkpoint {save.name}/..._1epochs restores {len(pairs)} tensors, step and count: "
              f"{'bit-exact' if exact else 'DIFFERENT'}")
        if not exact:
            raise AssertionError("the checkpoint does not restore the trained state bit for bit")

        # (b) one step on the card against the CPU, and the TF32 control
        batch = ds.batch(np.arange(n_check))
        ref_loss, ref_grads = one_train_step(torch.device("cpu"), batch, n_iters, features)
        loss_rel, grad_rel, worst, zero = grad_errors(*one_train_step(device, batch, n_iters, features),
                                                      ref_loss, ref_grads)
        print(f"train fp32 (b): one step on {n_check} galaxies vs CPU: loss rel err {loss_rel:.3e} (tol "
              f"{LOSS_REL_TOL}), worst gradient rel err {grad_rel:.3e} in {worst} (tol {GRAD_REL_TOL}), "
              f"zero-gradient biases {zero:.3e} of the largest gradient (tol {ZERO_GRAD_TOL})")
        tf32_rel = None
        if device.type == "cuda":
            _, tf32_rel, tf32_worst, _ = grad_errors(*one_train_step(device, batch, n_iters, features, tf32=True),
                                                     ref_loss, ref_grads)
            print(f"train fp32 (b) control: forward, loss and backward outside the train step with TF32 on, "
                  f"worst gradient rel err {tf32_rel:.3e} in {tf32_worst} (must exceed the tol {GRAD_REL_TOL})")
        if not (loss_rel <= LOSS_REL_TOL and grad_rel <= GRAD_REL_TOL and zero <= ZERO_GRAD_TOL):
            raise AssertionError("the card's train step disagrees with the CPU's")
        if tf32_rel is not None and tf32_rel <= GRAD_REL_TOL:
            raise AssertionError("the gradient check cannot tell a TF32 step from an fp32 one")

        # (c) and (d): n_steps on one batch; the loss falls; ms per step after n_warm
        model = UnrolledADMMGaussian(n_iters=n_iters, features=features).to(device)
        state, optimizer = create_train_state(model, 0)
        step = make_train_step(model, MultiScaleLoss(), optimizer)
        batch = ds.batch(np.arange(B))
        readings, times = [], []
        for _ in range(n_steps):
            _sync(device)
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            _sync(device)
            times.append(time.perf_counter() - t0)
            readings.append(float(loss))
    print(f"train fp32 (c): {n_steps} steps on one batch of {B}, loss " + " ".join(f"{x:.5g}" for x in readings))
    if not (np.isfinite(readings).all() and readings[-1] < readings[0]):
        raise AssertionError("the loss did not fall over steps on one batch")
    step_ms = float(np.median(times[n_warm:])) * 1e3
    return {"forward_launches": fwd, "backward_launches": bwd, "step_ms": step_ms, "gal_per_s": B / step_ms * 1e3,
            "batch": B, "timed_steps": len(times) - n_warm}


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
    kernel_bwd = phase_kernel_x_update_solve_backward(device, card)

    fp32 = phase_pipeline_fp32(device, repeats=10)
    bf16 = phase_pipeline_bf16(device, fp32, repeats=10)
    print(f"throughput ({card}): fp32 {fp32['gal_per_s']:.1f} gal/s, bf16 {bf16['gal_per_s']:.1f} gal/s "
          f"(B={BATCH}, 10 forwards + shear each, host clock around torch.cuda.synchronize())")
    train = phase_train_fp32(device)
    print(f"training ({card}): fp32, TF32 off, B={train['batch']}: {train['step_ms']:.2f} ms per train step, "
          f"{train['gal_per_s']:.1f} gal/s (median of {train['timed_steps']} steps after warm-up, host clock "
          f"around torch.cuda.synchronize())")
    # the main paths' runs: one fp32 pipeline forward, and the cli's epoch of training
    kernel["launches"] = fp32["launches"] + train["forward_launches"]
    kernel_bwd["launches"] = train["backward_launches"]

    print(card)
    print(json.dumps({"kernels": [kernel, kernel_bwd]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
