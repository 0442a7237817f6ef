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
             loss must fall; (d) train-step ms and gal/s at B = 32;
7. generate  ``galaxy_deconv_tpu_torch.cli generate`` on the card at the
             default pupil (512 across, a 1024 FFT grid): 256 train and 1,024
             test galaxies, all 7 fixed-SNR variants and 3 PSF-error levels
             of each kind; the tree's files, shapes and finiteness; its gal/s;
             and 8 galaxies rendered on the card and on the CPU from the same
             draws (parameters, noise, error signs), held at GEN_REL_TOL;
8. test      ``galaxy_deconv_tpu_torch.cli test`` on that tree: the shear,
             time, PSF-shear and PSF-FWHM sweeps, then ``run_psnr_test``, for
             the default methods (No_Deconv, FPFS, Richard-Lucy(10-100)),
             Wiener and Unrolled_ADMM_Gaussian(8) at full width with seed-0
             weights, at B = 512 over all 1,024 test galaxies: each sweep's
             gal/s, the results files' schema, the flagship's x_update_solve
             launches (8 per batch, none for the baselines); then Wiener,
             Richard-Lucy(30) and the flagship's reconstructions of 64 test
             galaxies and the baselines' rec_shear at SNR 20 against the
             CPU's;
9. zoo       the paper's learned baselines at full width with seed-0
             weights, on phase 7's tree: (a) Unrolled_ADMM(8) (Poisson,
             ResUNet(64..512) + SubNet(16)), Tikhonet_Laplacian, ShapeNet,
             ADMMNet(8), ADMMNet_fixed(8) and the ResUNet denoiser, fp32
             through ``make_apply_fn``, their reconstructions of 64 test
             galaxies on the card against the CPU's; (b) ``cli test --test
             shear`` for each at B = 512 over the 1,024 test galaxies: gal/s,
             the results' schema, no x_update_solve launch; (c) ``cli generate
             --task Denoise`` on the card, then ``cli train --model ResUNet``
             for one epoch on that tree; (d) ``cli train --model Tikhonet`` for
             one epoch on phase 6's stamps; for (c) and (d) finite losses, the
             checkpoint restoring bit for bit;
10. trainers the remaining trainers and losses at full width, weights from
             seed 0: (a) ``cli train --online`` of the flagship, 20 steps of
             B = 32 in calls of 10 on batches rendered on the card at the
             default optics, validation every 10 steps over 2 fixed batches:
             finite losses, the history and its best step, the step-20
             checkpoint restoring bit for bit, 8 + 8 solve launches per step
             and 8 per validation forward; one call of 10 steps run under
             ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), its
             ms per step, the simulator's share and the peak memory; one step
             on a batch rendered on the card against the same step on the
             CPU; (b) one epoch of ``fit_device_resident`` on phase 6's
             stamps: finite losses, the launches, its first step against
             ``make_train_step`` on the same minibatch, k = 4 steps of
             ``make_indexed_multi_step`` against 4 single steps, ms per step;
             (c) one epoch of ``cli train --model ShapeNet`` (the Shape loss,
             no solve launch, its checkpoint), and the Shape, BestEllipse and
             moment losses and their gradients on the card against the CPU;
11. data parallel   two ``torchrun`` calls, each rank this script run as
             ``chip_smoke.py --rank ...``: at world size 1 over NCCL, (a)
             ``cli train --n_devices 1`` for one epoch of phase 6's stamps,
             its per-step losses against phase 6's epoch (both under
             deterministic algorithms), the launches, the history, the
             checkpoint and the ms per step, then (c) ``cli test
             --n_devices 1`` of the flagship on phase 8's tree; over two gloo
             ranks sharing the card, (b) 3 steps of ``make_train_step(mesh)``
             on shards of 16 against one process on the global 32 (first
             loss, averaged gradient, running statistics, the replicas bit
             for bit, 8 + 8 solve launches per step per rank, the flat
             gradient's all-reduce timed), then (c) the same sweep at a
             global batch of 1,024; each sweep's rows against phase 8's, its
             gal/s and launches.
12. measurement  the measurement entry points at full width, weights from
             seed 0: (a) ``galaxy_deconv_tpu_torch bench`` (``cli bench``) in
             fp32 and bf16 at B = 256 and the CLI's default 1,024, a process
             each, each last line held to ``bench.py``'s schema; (b) the bench
             module's timed run in this process, fp32 at B = 256: its last
             rows equal to phase 4's bit for bit, 8 solve launches per forward
             and none of the backward; (c) ``scripts/mfu_torch.py`` in each
             dtype, timed on the card, its FLOP count equal to the count from
             the layers' shapes; (d) ``scripts/bench_pipeline_torch.py`` at
             B = 256 on phase 7's tree, one pass (the simulator, the reader,
             pageable and pinned copies: a check that the probe runs, the
             256-galaxy split too small to measure the reader); (e) ``examples/deconv_single_image_torch.py``
             with phase 6's checkpoint on phase 7's first test galaxy, on the
             card against the CPU (REC_REL_TOL, SHEAR_TOL), 8 solve launches;
             the phase's seconds.
13. scripts  the paper's reproduction, measurement and science scripts
             (``scripts/*_torch.py``), each through its ``main`` or the
             functions it is built from, in this process: (a)
             ``train_zoo_torch --models admm2 resunet`` for 4 steps of 32 at
             full width (validation every 2 steps): finite losses, the
             histories and checkpoints, 2 + 2 solve launches per ADMM(2)
             step and 2 per validation forward, none for the ResUNet; (b)
             ``export_trained_torch`` of (a), then ``run_benchmark_torch`` of
             No_Deconv and Unrolled_ADMM_Gaussian(2) on phase 7's tree, its
             shear rows equal to ``cli test``'s of the same checkpoint bit for
             bit and its tables between the markers of its RESULTS.md; (c)
             ``reference_protocol_torch`` for 2 epochs of 512 stamps: the
             checkpoints the save rule names, ``best_epoch`` from its history;
             (d) ``generate_sharded_torch``, two workers and the merge, against
             ``generate_dataset`` byte for byte; (e) ``profile_ops_torch`` in
             fp32 at B = 256, its ``full`` rows equal to phase 4's bit for bit
             and 8 solve launches a ``fftpath`` call, and
             ``reconcile_throughput_torch``'s configurations with phase 6's
             checkpoint, A's and B's shears within SCRIPT_SHEAR_TOL; (f)
             ``scaling_torch`` under ``torchrun`` at world size 1 over NCCL;
             (g) ``rho_trace_torch``'s statistics, ``make_figures_torch``'s
             trace arrays and ``cross_estimator_torch``'s statistics, card
             against CPU, and ``population_sweep_torch`` on two populations;
             the phase's seconds.
14. trained  the JAX package's trained flagship (epoch 7000 of
             ``Gaussian_PnP_ADMM_8iters_MultiScale``) from ``trained_port/``,
             with the JAX package's outputs on 64 fixed stamps
             (``trained_port/flagship_goldens.npz``): (a) restored through
             ``train/checkpoint.py`` into ``build_pipeline``, its tensors equal
             to the file's (a missing checkpoint fails the phase); (b) fp32
             reconstructions and shears against JAX's (TRAINED_REC_REL_TOL,
             TRAINED_SHEAR_TOL), 8 solve launches, and a TF32 control that must
             fail them; (c) bf16 nets against JAX's bf16 nets; (d) the stamps
             written as a COSMOS-layout tree by ``generate_galsim.
             write_packed_dataset``, ``cli test --checkpoint_name`` on it
             against JAX's shears, and ``generate_galsim.observe`` on the card
             against the CPU; (e) ``cli test --test shear`` of the trained
             flagship on phase 7's tree, its median |g - g_true| per SNR
             beside phase 8's seed-0 flagship's; the phase's seconds.

The last three lines are the card's name and power limit, one JSON object
with each kernel's numbers, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib.util
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from galaxy_deconv_tpu_torch import bench, cli
from galaxy_deconv_tpu_torch.bench import bench_inputs
from galaxy_deconv_tpu_torch.data import FIELDS, GalaxyDataset, generate_dataset, train_val_indices
from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.data.generate_galsim import observe, write_packed_dataset
from galaxy_deconv_tpu_torch.eval import harness
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss, build_loss, get_model_name
from galaxy_deconv_tpu_torch.metrics.shear import estimate_shear, fpfs_moments
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.models import registry
from galaxy_deconv_tpu_torch.ops import native
from galaxy_deconv_tpu_torch.ops import x_update as xu
from galaxy_deconv_tpu_torch.pipeline import build_pipeline
from galaxy_deconv_tpu_torch.train import (
    create_train_state,
    default_optimizer,
    fit_device_resident,
    make_indexed_multi_step,
    make_indexed_train_step,
    make_online_train_scan,
    make_train_step,
    restore_checkpoint,
    upload_split,
)
from galaxy_deconv_tpu_torch.train.checkpoint import (best_epoch, find_checkpoint, latest_epoch, state_payload,
                                                      unpack_variables)
from galaxy_deconv_tpu_torch.train.online import TRAIN, step_seed
from galaxy_deconv_tpu_torch.utils.device import card_name_and_power_limit, fp32_only

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
# The simulator and the baselines, card against CPU on the same inputs: float32
# FFTs (cuFFT against pocketfft) of a 1024-wide pupil and 192- or 48-wide
# stamps.  Limits fixed before the first reading on the card: renders and
# reconstructions to max |card - CPU| / max |CPU| of each field; the baselines'
# shears to |g_card - g_cpu| / (1 + |g_cpu|).  The CPU reads 2e-7 to 3e-6
# against the JAX package on the same inputs (tests/test_torch_simulate.py,
# tests/test_torch_eval.py).
GEN_REL_TOL = 1e-4
BASELINE_REC_REL_TOL = 1e-4
BASELINE_SHEAR_TOL = 1e-4
SNRS = (20, 40, 60, 80, 100, 150, 200)  # cli generate's fixed-SNR variants
PSF_ERRS = (0.01, 0.05, 0.1)
EVAL_BATCH = 512  # config.py's eval_batch_size
EVAL_METHODS = (*cli.DEFAULT_METHODS, "Wiener", "Unrolled_ADMM_Gaussian(8)")
# The zoo's seed-0 reconstructions, card against CPU, max |d| / max |CPU|: the
# BASELINE_REC_REL_TOL above, fixed before the first reading.
ZOO_METHODS = ("Unrolled_ADMM(8)", "Tikhonet_Laplacian", "ShapeNet", "ADMMNet(8)", "ADMMNet_fixed(8)", "ResUNet")
# Phase 10.  Card against CPU on the same inputs, limits fixed before the first
# reading: the first device-resident step against make_train_step on the same
# minibatch and card (only the order of the card's own sums differs) at
# DR_LOSS_REL_TOL of the loss; k fused indexed steps against k single ones:
# the losses at LOSS_REL_TOL, the parameters within MULTI_PARAM_TOL learning
# rates (as tests/test_torch_train.py holds 3 steps to JAX; the SubNet's
# zero-gradient conv biases only finite).  The Shape, BestEllipse and moment
# losses: values to LOSS_VALUE_REL_TOL, gradients to LOSS_GRAD_TOL of the
# largest CPU entry; BestEllipse with the card's conics (the SVD's last right
# singular vector, whose sign no solver fixes) given the CPU's signs, the
# share of conics whose signs differ printed.
# BestEllipse's value is held otherwise: the card's and the CPU's float32
# values each against the float64 value on the same inputs (every side's
# conics with the CPU's signs), at BEST_ELLIPSE_VALUE_REL_TOL.  Its float32
# conics (smallest singular vectors) and the conic-to-ellipse algebra carry
# ~1e-5 of the value on their own: the CPU's float32 value reads 1.58e-5 from
# its float64 value on phase 6's stamps, and the card's 1.74e-5 from the
# CPU's, so the card-against-CPU limit of 1e-5 fixed first could not hold the
# CPU's own rounding; the limit is set above those readings.
DR_LOSS_REL_TOL = 1e-6
MULTI_PARAM_TOL = 0.02
LOSS_VALUE_REL_TOL = 1e-5
BEST_ELLIPSE_VALUE_REL_TOL = 5e-5
LOSS_GRAD_TOL = 1e-4
ONLINE_STEPS, ONLINE_PER_CALL, ONLINE_VAL_EVERY, ONLINE_VAL_BATCHES = 20, 10, 10, 2
# Phase 11, data parallel.  Limits fixed before the first reading on the card: the world-1 epoch's per-step
# losses against phase 6's epoch, relative to the largest (both under deterministic algorithms; a world of one
# rank takes no BatchNorm collective, so only the flat gradient's all-reduce differs); two gloo ranks of 16
# against one process on the global 32 from the same weights (deterministic algorithms on both sides): the first
# loss at DP_LOSS_REL_TOL, the ranks' averaged first gradient at GRAD_REL_TOL (the zero-gradient biases at
# ZERO_GRAD_TOL of the largest), the BatchNorm running statistics after it at DP_STATS_TOL of each tensor's
# largest entry, the two replicas bit for bit after DP_STEPS steps.  The later steps are printed, not held: the
# first gradients differ by rounding (~4e-3 of a tensor's largest entry, as the card's against the CPU's), and
# Adam moves every entry whose sign that flips by 2 lr.  The mesh sweeps' shear rows against phase 8's
# single-device rows at DP_SHEAR_TOL * (1 + |g|), the moments' limit (the same card, each rank's shard of
# phase 8's batch shape).
DP_LOSS_REL_TOL = 1e-5
DP_STATS_TOL = 1e-5
DP_SHEAR_TOL = MOMENT_REL_TOL
DP_STEPS = 3
DP_TIMEOUT_S = 300  # each torchrun call, its ranks' start-up included
# Phase 12, the measurement entry points.  ``cli bench`` at bench.py's batch and the CLI's default, in each dtype,
# each in a process of its own as a user runs it; the bench module's timed run in this process, whose fp32 rows at
# BATCH must equal phase 4's bit for bit (the same code, weights and inputs on the same card).
BENCH_BATCHES = (BATCH, 1024)
MEASURE_REPEATS = 10
COMMAND_TIMEOUT_S = 240  # each cli bench process, its start-up included
# Phase 13, the scripts.  Limits fixed before the first reading on the card: reconcile's fp32 configurations A
# (batch 250) and B (batch 256) on the same galaxies, whose convolutions cuDNN may run by other algorithms, at
# SCRIPT_SHEAR_TOL * (1 + |g|); rho_trace's statistics and make_figures' trace arrays, card against CPU (fp32, TF32
# off), at REC_REL_TOL of each field's largest CPU value; the cross-estimator statistics at SCRIPT_STAT_TOL * (1 +
# |CPU|).  Sizes cut for the phase's time: PERF.md section 4.
SCRIPT_SHEAR_TOL = 1e-4
SCRIPT_STAT_TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent
# Phase 14, the trained flagship.  trained_port/ holds the JAX package's trained flagship in the port's format
# (scripts/trained_to_port.py) and the JAX package's outputs on 64 fixed stamps (scripts/flagship_goldens.py).
# Limits fixed before the first reading on the card, from two readings: the port on the CPU against these
# goldens reads 6.3e-6 to 7.3e-6 (reconstruction, max |d| / max |JAX|; 2 to 8 threads) and 2.9e-6 to 3.0e-6 (g,
# max |dg| / (1 + |g|)); phase 4's card against the CPU reads 1.13e-5 on seed-0 weights (NVIDIA H100 80GB HBM3,
# 700 W), its TF32 control 6.5e-3.  So the card against JAX should read ~2e-5 on the reconstruction; a limit of
# 1e-4 leaves 5x and stays 60x under a TF32 run.  With trained weights R1E does not cancel: on the CPU g moves by half the reconstruction's
# relative error (2.9e-6 against 6.3e-6), so g is held at 1e-4 (1 + |g|), 100x tighter than SHEAR_TOL.
TRAINED_REC_REL_TOL = 1e-4
TRAINED_SHEAR_TOL = 1e-4
# bf16 nets against the JAX package's bf16 nets: the frameworks round bf16 convolutions differently, so two bf16
# runs differ about as much as bf16 from fp32 (the JAX bf16 golden against its fp32 golden: 2.85e-2).  The port's
# CPU reads 2.48e-2 against the bf16 golden; the limit is tests/test_torch_model.py's BF16_REL for this checkpoint.
TRAINED_BF16_REL_TOL = 6e-2
# generate_galsim.observe computes in float64 and rounds to float32: card against CPU at 1e-6 of each peak.
OBSERVE_REL_TOL = 1e-6
TRAINED_DIR = REPO / "trained_port"
TRAINED_RUN = "Gaussian_PnP_ADMM_8iters_MultiScale"
COSMOS_SNR = 20  # the label of the goldens' one fixed-SNR variant in the COSMOS-layout tree


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


def _check_checkpoint(state, save: pathlib.Path, name: str, epoch: int = 1) -> int:
    """The checkpoint ``epoch`` of run ``name`` restores ``state`` bit for bit;
    returns the number of tensors compared."""
    restored, trained = restore_checkpoint(save, name, epoch), state_payload(state)
    pairs = [(trained["model"][k], restored["model"][k]) for k in trained["model"]]
    pairs += [(trained["opt_state"][m][k], restored["opt_state"][m][k]) for m in ("mu", "nu")
              for k in trained["opt_state"][m]]
    if not (all(torch.equal(a.cpu(), b) for a, b in pairs) and restored["step"] == state.step
            and restored["opt_state"]["count"] == trained["opt_state"]["count"]):
        raise AssertionError(f"the checkpoint of {name} does not restore the trained state bit for bit")
    return len(pairs)


def phase_train_fp32(device, B=TRAIN_BATCH, n_stamps=N_STAMPS, n_iters=FLAGSHIP["n_iters"],
                     features=FLAGSHIP["features"], n_check=N_CPU_CHECK, n_steps=20, n_warm=5,
                     save: pathlib.Path | None = None) -> dict:
    """Phase 6; ``cli train`` checkpoints into ``save`` (default: a directory removed after the phase)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = write_dataset(pathlib.Path(tmp) / "data", n_stamps)
        save = save or pathlib.Path(tmp) / "models"
        ds = GalaxyDataset(root)

        # (a) the command line, one epoch at full width, each step's loss and ms recorded for phase 11 (which
        # holds its world-1 epoch to these losses, so both run cuDNN's deterministic algorithms)
        xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
        with recording_steps() as epoch_steps, deterministic():
            state, hist = cli.main(["train", "--data_path", str(root), "--model_save_path", str(save), "--n_epochs",
                                    "1", "--batch_size", str(B), "--n_iters", str(n_iters), "--seed", "0",
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
        n = _check_checkpoint(state, save, get_model_name("Unrolled_ADMM", "MultiScale", n_iters=n_iters))
        print(f"train fp32 (a): checkpoint {save.name}/..._1epochs restores {n} tensors, step and count: bit-exact")

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
            "batch": B, "timed_steps": len(times) - n_warm, "epoch_steps": epoch_steps}


def phase_generate(device, root: pathlib.Path, n_train=256, n_test=1024, pupil_n=512, chunk=256, errs=PSF_ERRS,
                   n_check=N_CPU_CHECK) -> dict:
    """``cli generate`` on ``device`` into ``root``, the tree checked, and
    ``n_check`` galaxies rendered on the device and on the CPU from the same draws."""
    _sync(device)
    t0 = time.perf_counter()
    cli.main(["generate", "--data_path", str(root), "--n_train", str(n_train), "--n_test", str(n_test),
              "--pupil_n", str(pupil_n), "--chunk", str(chunk), "--seed", "0", "--device", device.type,
              "--errs", *map(str, errs)])
    _sync(device)
    seconds = time.perf_counter() - t0
    scenes = n_train + n_test * (1 + len(SNRS))  # PSF + galaxy + observation renders
    psf_only = n_test * 2 * len(errs)
    splits = (("train", n_train), ("test", n_test))
    want = {f"{s}/{k}.npy": (n, 48, 48) for s, n in splits for k in ("obs", "psf", "gt")}
    want.update({f"test/{v}_{snr}.npy": (n_test, 48, 48) for snr in SNRS for v in ("obs", "gt")})
    want.update({f"test/psf_{kind}_err_{e}.npy": (n_test, 48, 48) for kind in ("shear", "fwhm") for e in errs})
    want.update({f"{s}/{k}.npy": (n,) for s, n in splits for k in ("alpha", "snr", "gal_g1", "gal_g2")})
    for name, shape in want.items():
        a = np.load(root / name)
        if a.shape != shape or a.dtype != np.float32 or not np.isfinite(a).all():
            raise AssertionError(f"generate: {name} is {a.dtype} {a.shape}, finite {np.isfinite(a).all()}")
    psf_sum = np.load(root / "test" / "psf.npy").sum(axis=(1, 2))
    if not np.allclose(psf_sum, 1 / 16, rtol=1e-4):
        raise AssertionError(f"generate: PSF stamps sum to {psf_sum.min()}-{psf_sum.max()}, not 1/16")
    print(f"generate ({device.type}): {n_train} train + {n_test} test galaxies, {len(SNRS)} SNR variants, "
          f"{len(errs)} PSF-error levels of each kind, pupil {pupil_n} on a {2 * pupil_n} grid: {seconds:.2f} s, "
          f"{(n_train + n_test) / seconds:.1f} gal/s ({scenes / seconds:.1f} scenes/s over {scenes} PSF + galaxy + "
          f"observation renders, plus {psf_only} PSF-only renders; host clock around the command, file writes "
          f"included); {len(want)} files of the expected shapes, finite, PSFs summing to 1/16")

    # the same draws rendered on the device and on the CPU
    cfg = sim.SimulationConfig(pupil_n=pupil_n, pupil_pad=2 * pupil_n)
    pgen, ngen, sgen = sim.chunk_generators(12345, device)
    params, noise, signs = sim.sample_params(pgen, n_check, cfg), sim.draw_noise(ngen, n_check, cfg), \
        sim.draw_signs(sgen, n_check)
    out = sim.render_batch(params, noise, cfg)
    out["psf_shear_err"] = sim.render_perturbed_psfs(params, signs, cfg, shear_err=errs[-1])
    out["psf_fwhm_err"] = sim.render_perturbed_psfs(params, signs, cfg, fwhm_err=errs[-1])
    cpu = {k: v.cpu() for k, v in params.items()}
    ref = sim.render_batch(cpu, noise.cpu(), cfg)
    ref["psf_shear_err"] = sim.render_perturbed_psfs(cpu, signs.cpu(), cfg, shear_err=errs[-1])
    ref["psf_fwhm_err"] = sim.render_perturbed_psfs(cpu, signs.cpu(), cfg, fwhm_err=errs[-1])
    rel = {k: float((out[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()) for k in ref}
    print(f"generate ({device.type}) vs CPU, {n_check} galaxies from the same draws: max |d| / max |CPU| "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (tol {GEN_REL_TOL})")
    if max(rel.values()) > GEN_REL_TOL:
        raise AssertionError("the device's renders disagree with the CPU's")
    return {"seconds": seconds, "gal_per_s": (n_train + n_test) / seconds, "scenes_per_s": scenes / seconds,
            "rel": rel, "n_test": n_test}


def _check_results(res: pathlib.Path, method: str, n_gal: int, snrs, errs) -> None:
    """The results files of one method after every sweep: the JAX package's schema."""
    r = json.loads((res / method / "results.json").read_text())
    keys = {"rec_shear", "data_root", "psnr_mean", "psnr_median"} | ({"gt_shear"} if method == "No_Deconv" else set())
    if set(r) != {*map(str, snrs), "time", "time_spread", "meta"}:
        raise AssertionError(f"{method}/results.json keys {sorted(r)}")
    for snr in map(str, snrs):
        if set(r[snr]) != keys:
            raise AssertionError(f"{method}/results.json[{snr}] keys {sorted(r[snr])}")
        for k in ("rec_shear", "gt_shear"):
            if k in r[snr] and (np.shape(r[snr][k]) != (n_gal, 3) or not np.isfinite(r[snr][k]).all()):
                raise AssertionError(f"{method} snr {snr} {k}: shape {np.shape(r[snr][k])} or not finite")
    if len(r["time"]) != 2 or len(r["time_spread"]) != 2:
        raise AssertionError(f"{method}: time {r['time']}, time_spread {r['time_spread']}")
    for kind in ("shear", "fwhm"):
        p = json.loads((res / method / f"results_psf_{kind}_err.json").read_text())
        if set(p) != {*map(str, errs), "meta"} or any(np.shape(p[str(e)]["rec_shear"]) != (n_gal, 3) for e in errs):
            raise AssertionError(f"{method}/results_psf_{kind}_err.json: keys {sorted(p)}")


def phase_test(device, root: pathlib.Path, res: pathlib.Path, card: str, methods=EVAL_METHODS,
               flagship="Unrolled_ADMM_Gaussian(8)", n_gal=1024, batch=EVAL_BATCH, snrs=SNRS, errs=PSF_ERRS,
               n_check=64) -> dict:
    """``cli test`` on ``device`` over ``root``: every sweep of every method, timed;
    the schema; the flagship's kernel launches; the card against the CPU."""
    base = ["test", "--data_path", str(root), "--result_path", str(res), "--n_gal", str(n_gal),
            "--eval_batch_size", str(batch), "--device", device.type, "--snrs", *map(str, snrs),
            "--errs", *map(str, errs)]
    batches = -(-n_gal // batch)
    timed = max(batch, n_gal // batch * batch)
    # per sweep: (galaxies, batches); time: 2 warm-up sweeps of one batch, then 3 timed sweeps
    per_snr, per_err = (len(snrs) * n_gal, len(snrs) * batches), (len(errs) * n_gal, len(errs) * batches)
    sweeps = {"shear": per_snr, "time": (None, 2 + 3 * timed // batch), "psf_shear": per_err, "psf_fwhm": per_err,
              "psnr": per_snr}
    n_iters = int(flagship.rsplit("(", 1)[1].rstrip(")"))
    rates, launches = {}, {}
    for method in methods:
        xu.x_update_solve.launches = 0
        for kind, (gals, _) in sweeps.items():
            _sync(device)
            t0 = time.perf_counter()
            if kind == "psnr":  # not a cli sweep, as in the JAX package
                harness.run_psnr_test(method, root, res, snrs=snrs, n_gal=n_gal, batch_size=batch, device=device)
            else:
                cli.main(base + ["--test", kind, "--methods", method])
            _sync(device)
            rates[(method, kind)] = gals / (time.perf_counter() - t0) if gals else None
        launches[method] = xu.x_update_solve.launches
        r = json.loads((res / method / "results.json").read_text())
        rates[(method, "time")] = r["time"][1] / r["time"][0]
        _check_results(res, method, n_gal, snrs, errs)
        want = n_iters * sum(nb for _, nb in sweeps.values()) if (device.type == "cuda" and method == flagship) else 0
        if launches[method] != want:
            raise AssertionError(f"{method}: x_update_solve launched {launches[method]} times, expected {want}")
    print(f"test ({device.type}, {card}): gal/s per sweep at B={batch} over {n_gal} test galaxies (shear and psnr "
          f"over {len(snrs)} SNR variants, psf over {len(errs)} levels; host clock around each command, model build, "
          f"uploads and the results file included; time: the harness's median of 3 sweeps of {timed} galaxies "
          f"after warm-up):")
    for method in methods:
        print(f"test   {method:26s} " + "  ".join(f"{k} {rates[(method, k)]:9.1f}" for k in sweeps)
              + f"  x_update_solve launches {launches[method]}")

    # the card against the CPU: reconstructions of n_check test galaxies
    b = GalaxyDataset(root, "test").batch(np.arange(n_check))
    rec_rel = {}
    for method in ("Wiener", "Richard-Lucy(30)", flagship):
        got, want = (harness.make_apply_fn(method, device=d)(*(torch.as_tensor(b[k], device=d)
                                                               for k in ("obs", "psf", "alpha"))).cpu()
                     for d in (device, torch.device("cpu")))
        rec_rel[method] = float((got - want).abs().max() / want.abs().max())
    # the baselines' shears at SNR 20: the CPU harness on the first n_check galaxies
    shear_err = {}
    for method in methods:
        if method == flagship:
            continue
        ref = np.asarray(harness.run_shear_test(method, root, res / "cpu", snrs=(20,), n_gal=n_check,
                                                batch_size=n_check, device="cpu")["20"]["rec_shear"])
        got = np.asarray(json.loads((res / method / "results.json").read_text())["20"]["rec_shear"][:n_check])
        shear_err[method] = float((np.abs(got - ref) / (1 + np.abs(ref))).max())
    print(f"test ({device.type}) vs CPU, {n_check} test galaxies: reconstructions max |d| / max |CPU| "
          + ", ".join(f"{k} {v:.3e}" for k, v in rec_rel.items())
          + f" (tol {BASELINE_REC_REL_TOL}; the flagship {REC_REL_TOL}); rec_shear at SNR 20 max |dg| / (1 + |g|) "
          + ", ".join(f"{k} {v:.3e}" for k, v in shear_err.items()) + f" (tol {BASELINE_SHEAR_TOL})")
    if any(v > (REC_REL_TOL if k == flagship else BASELINE_REC_REL_TOL) for k, v in rec_rel.items()):
        raise AssertionError("the device's reconstructions disagree with the CPU's")
    if max(shear_err.values()) > BASELINE_SHEAR_TOL:
        raise AssertionError("the device's baseline shears disagree with the CPU's")
    return {"rates": rates, "launches": launches, "rec_rel": rec_rel, "shear_err": shear_err}


def phase_zoo(device, root: pathlib.Path, work: pathlib.Path, card: str, methods=ZOO_METHODS, n_gal=1024,
              batch=EVAL_BATCH, snrs=SNRS, n_check=64, n_denoise=N_STAMPS, train_batch=TRAIN_BATCH,
              model_kwargs=None) -> dict:
    """The zoo on ``device``: (a) seed-0 reconstructions against the CPU's, (b)
    ``cli test --test shear`` over ``root``, (c) the Denoise tree and one epoch
    of ``cli train --model ResUNet`` on it, (d) one epoch of ``cli train
    --model Tikhonet`` on :func:`write_dataset`'s stamps.  ``model_kwargs``
    (per method) narrows the models for a run on the CPU; the cli runs take
    the full widths."""
    model_kwargs = model_kwargs or {}
    # (a) card against CPU
    b = GalaxyDataset(root, "test").batch(np.arange(n_check))
    rec_rel = {}
    for method in methods:
        kw = model_kwargs.get(method, {})
        got, want = (harness.make_apply_fn(method, device=d, **kw)(*(torch.as_tensor(b[k], device=d)
                                                                     for k in ("obs", "psf", "alpha"))).cpu()
                     for d in (device, torch.device("cpu")))
        if got.shape != (n_check, 48, 48) or not torch.isfinite(got).all():
            raise AssertionError(f"zoo {method}: reconstruction {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        rec_rel[method] = float((got - want).abs().max() / want.abs().max())
    print(f"zoo (a) ({device.type}) vs CPU, seed-0 weights, fp32, {n_check} test galaxies: reconstructions max |d| / "
          f"max |CPU| " + ", ".join(f"{k} {v:.3e}" for k, v in rec_rel.items()) + f" (tol {BASELINE_REC_REL_TOL})")
    if max(rec_rel.values()) > BASELINE_REC_REL_TOL:
        raise AssertionError("the device's zoo reconstructions disagree with the CPU's")

    # (b) the shear sweep of each method through the command line
    rates = {}
    res = work / "results"
    for method in methods:
        xu.x_update_solve.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        cli.main(["test", "--data_path", str(root), "--result_path", str(res), "--n_gal", str(n_gal),
                  "--eval_batch_size", str(batch), "--device", device.type, "--snrs", *map(str, snrs), "--test",
                  "shear", "--methods", method])
        _sync(device)
        rates[method] = len(snrs) * n_gal / (time.perf_counter() - t0)
        r = json.loads((res / method / "results.json").read_text())
        if set(r) != {*map(str, snrs), "meta"} or r["meta"]["n_gal"] != n_gal:
            raise AssertionError(f"zoo {method}/results.json keys {sorted(r)}")
        for snr in map(str, snrs):
            if set(r[snr]) != {"rec_shear", "data_root"} or np.shape(r[snr]["rec_shear"]) != (n_gal, 3) \
                    or not np.isfinite(r[snr]["rec_shear"]).all():
                raise AssertionError(f"zoo {method} snr {snr}: keys {sorted(r[snr])}, rec_shear "
                                     f"{np.shape(r[snr]['rec_shear'])}, finite {np.isfinite(r[snr]['rec_shear']).all()}")
        if xu.x_update_solve.launches:
            raise AssertionError(f"zoo {method}: x_update_solve launched {xu.x_update_solve.launches} times")
    print(f"zoo (b) ({device.type}, {card}): cli test --test shear at B={batch} over {n_gal} test galaxies x "
          f"{len(snrs)} SNR variants, gal/s (host clock around each command, model build and uploads included), "
          "x_update_solve launches 0: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))

    # (c) the Denoise task: generate, then one epoch of the ResUNet denoiser; (d) one epoch of Tikhonet
    dn = work / "denoise"
    _sync(device)
    t0 = time.perf_counter()
    cli.main(["generate", "--task", "Denoise", "--data_path", str(dn), "--n_train", str(n_denoise), "--n_test",
              str(train_batch), "--seed", "0", "--device", device.type])
    _sync(device)
    gen_s = time.perf_counter() - t0
    info = json.loads((dn / "info.json").read_text())
    obs = np.load(dn / "train" / "obs.npy")
    if info["task"] != "Denoise" or obs.shape != (n_denoise, 48, 48) or np.load(dn / "train" / "psf.npy").any():
        raise AssertionError(f"Denoise tree: task {info['task']}, obs {obs.shape}")
    stamps = write_dataset(work / "stamps", n_denoise)
    train = {}
    for model, data, name in (("ResUNet", dn, "ResUNet_MultiScale"),
                              ("Tikhonet", stamps, "Tikhonet_Laplacian_MultiScale")):
        save = work / "models"
        xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
        state, hist = cli.main(["train", "--model", model, "--data_path", str(data), "--model_save_path", str(save),
                                "--n_epochs", "1", "--batch_size", str(train_batch), "--seed", "0",
                                "--device", device.type])
        _sync(device)
        losses = hist["train_loss"] + hist["val_loss"]
        if not np.isfinite(losses).all() or state.step != int(0.9 * n_denoise) // train_batch:
            raise AssertionError(f"cli train --model {model}: {state.step} steps, losses {losses}")
        if xu.x_update_solve.launches or xu.x_update_solve_backward.launches:
            raise AssertionError(f"cli train --model {model} launched the solve kernels")
        n = _check_checkpoint(state, save, name)
        train[model] = {"steps": state.step, "epoch_s": hist["epoch_time"][0]}
        print(f"zoo ({'c' if model == 'ResUNet' else 'd'}) ({device.type}, {card}): cli train --model {model}, one "
              f"epoch of {state.step} steps at B={train_batch} on {'the Denoise tree' if model == 'ResUNet' else 'the stamps'}"
              f": train_loss {hist['train_loss'][0]:.6g}, val_loss {hist['val_loss'][0]:.6g}, epoch "
              f"{hist['epoch_time'][0]:.2f} s ({state.step * train_batch / hist['epoch_time'][0]:.1f} gal/s with "
              f"validation); checkpoint restores {n} tensors bit-exact; no solve launches")
    print(f"zoo (c): cli generate --task Denoise, {n_denoise} + {train_batch} galaxies: {gen_s:.2f} s")
    return {"rec_rel": rec_rel, "rates": rates, "train": train, "denoise_s": gen_s}


def phase_online(device, card: str, save: pathlib.Path, B=TRAIN_BATCH, n_steps=ONLINE_STEPS, k=ONLINE_PER_CALL,
                 val_every=ONLINE_VAL_EVERY, val_batches=ONLINE_VAL_BATCHES, pupil_n=512,
                 n_iters=FLAGSHIP["n_iters"], features=FLAGSHIP["features"], n_check=N_CPU_CHECK,
                 zero_tol=ZERO_GRAD_TOL) -> dict:
    """Phase 10 (a): ``cli train --online``, then one fused call checked for
    host syncs and timed, and one step on a rendered batch against the CPU
    (``zero_tol``: the zero-gradient biases' limit, ZERO_GRAD_TOL for the
    full-width flagship).  The command runs ``fit_online`` with its cadences
    set here (its defaults validate every 500 steps and save every 5,000) and
    with a ``pupil_n`` pupil (the command's optics are the default 512)."""
    name = get_model_name("Unrolled_ADMM", "MultiScale", n_iters=n_iters)
    cadences = functools.partial(cli.fit_online, val_every=val_every, val_batches=val_batches, save_every=n_steps)
    optics = functools.partial(sim.SimulationConfig, pupil_n=pupil_n, pupil_pad=2 * pupil_n)
    xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
    with mock.patch.object(cli, "fit_online", cadences), mock.patch.object(cli, "SimulationConfig", optics):
        state, hist = cli.main(["train", "--online", "--n_steps", str(n_steps), "--steps_per_call", str(k),
                                "--batch_size", str(B), "--n_iters", str(n_iters), "--model_save_path", str(save),
                                "--seed", "0", "--device", device.type])
    _sync(device)
    fwd, bwd = xu.x_update_solve.launches, xu.x_update_solve_backward.launches
    vals = n_steps // val_every
    written = json.loads((save / f"{name}_history.json").read_text())
    if (state.step != n_steps or hist["step"] != [val_every * (i + 1) for i in range(vals)] or written != hist
            or not np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
            or hist["best_step"] not in hist["step"] or checkpoint_steps(save, name) != {*hist["step"]}):
        raise AssertionError(f"cli train --online: {state.step} steps, history {hist}")
    want = (n_iters * (n_steps + vals * val_batches), n_iters * n_steps) if device.type == "cuda" else (0, 0)
    if (fwd, bwd) != want:
        raise AssertionError(f"online: solve launches forward {fwd}, backward {bwd}; expected {want}")
    n = _check_checkpoint(state, save, name, n_steps)
    print(f"trainers (a) ({device.type}, {card}): cli train --online, {n_steps} steps of B={B} in calls of {k}, "
          f"n_iters={n_iters}, pupil {pupil_n}: train_loss " + " ".join(f"{x:.6g}" for x in hist["train_loss"])
          + ", val_loss " + " ".join(f"{x:.6g}" for x in hist["val_loss"]) + f" over {val_batches} fixed batches, "
          f"best step {hist['best_step']}, {hist['galaxies_per_sec']:.1f} gal/s with validation and checkpoints; "
          f"solve launches forward {fwd}, backward {bwd}; the step-{n_steps} checkpoint restores {n} tensors, step "
          "and count bit-exact")

    # one fused call under the sync debugger, then a timed one
    cfg = sim.SimulationConfig(pupil_n=pupil_n, pupil_pad=2 * pupil_n)
    model = UnrolledADMMGaussian(n_iters=n_iters, features=features).to(device)
    st, optimizer = create_train_state(model, 0)
    scan = make_online_train_scan(model, MultiScaleLoss(), optimizer, B, k, cfg)
    call = iter(range(10**6))

    def run():
        c = next(call)
        return scan(st, [step_seed(0, TRAIN, c * k + j) for j in range(k)])[1]

    run()  # warm-up: FFT plans, the simulator's grids
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
    try:
        losses = run()
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    _sync(device)
    t0 = time.perf_counter()
    losses = torch.cat([losses, run()]).cpu()
    _sync(device)
    step_ms = (time.perf_counter() - t0) / k * 1e3
    if not torch.isfinite(losses).all():
        raise AssertionError(f"online fused calls: losses {losses.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
    render_ms = (eager_ms(lambda: sim.simulate_batch(12345, B, cfg, device=device), 5) if device.type == "cuda"
                 else float("nan"))
    print(f"trainers (a) ({device.type}, {card}): a call of {k} online steps ran under "
          f"torch.cuda.set_sync_debug_mode('error') with no host sync; {step_ms:.2f} ms per step, "
          f"{B / step_ms * 1e3:.1f} gal/s (one call of {k} after warm-up, host clock around it); the simulator "
          f"alone {render_ms:.2f} ms per batch of {B} ({render_ms / step_ms:.1%} of a step); peak memory "
          f"{peak:.2f} GiB")

    # one step on a batch rendered on the device, against the same step on the CPU
    rendered = sim.simulate_batch(step_seed(0, TRAIN, 10**6), n_check, cfg, device=device)
    batch = {k_: v.cpu().numpy() for k_, v in rendered.items()}
    batch["alpha"] = batch["obs"].mean(axis=(-2, -1))
    ref_loss, ref_grads = one_train_step(torch.device("cpu"), batch, n_iters, features)
    loss_rel, grad_rel, worst, zero = grad_errors(*one_train_step(device, batch, n_iters, features),
                                                  ref_loss, ref_grads)
    print(f"trainers (a): one step on {n_check} galaxies rendered on {device.type}, vs CPU: loss rel err "
          f"{loss_rel:.3e} (tol {LOSS_REL_TOL}), worst gradient rel err {grad_rel:.3e} in {worst} (tol "
          f"{GRAD_REL_TOL}), zero-gradient biases {zero:.3e} (tol {zero_tol})")
    if not (loss_rel <= LOSS_REL_TOL and grad_rel <= GRAD_REL_TOL and zero <= zero_tol):
        raise AssertionError("the card's online step disagrees with the CPU's")
    return {"forward_launches": fwd, "backward_launches": bwd, "step_ms": step_ms, "render_ms": render_ms,
            "peak_gib": peak, "hist": hist}


def checkpoint_steps(save: pathlib.Path, name: str) -> set:
    """The step or epoch numbers of run ``name``'s checkpoint directories."""
    pat = re.compile(re.escape(name) + r"_(\d+)epochs$")
    return {int(m.group(1)) for p in save.iterdir() if (m := pat.match(p.name))}


def _fresh(device, n_iters, features):
    model = UnrolledADMMGaussian(n_iters=n_iters, features=features).to(device)
    return (model, *create_train_state(model, 0))


def phase_device_resident(device, card: str, root: pathlib.Path, B=TRAIN_BATCH, n_iters=FLAGSHIP["n_iters"],
                          features=FLAGSHIP["features"], k=4) -> dict:
    """Phase 10 (b): one epoch of ``fit_device_resident``; its step against
    ``make_train_step``; k fused indexed steps against k single ones."""
    ds = GalaxyDataset(root)
    model, state, optimizer = _fresh(device, n_iters, features)
    xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
    state, hist = fit_device_resident(model, state, optimizer, MultiScaleLoss(), ds, n_epochs=1, batch_size=B,
                                      train_val_split=0.9, seed=0)
    _sync(device)
    fwd, bwd = xu.x_update_solve.launches, xu.x_update_solve_backward.launches
    tr_idx, _ = train_val_indices(len(ds), 0.9, 0)
    steps = len(tr_idx) // B
    want = (n_iters * (steps + 1), n_iters * steps) if device.type == "cuda" else (0, 0)
    if state.step != steps or not np.isfinite(hist["train_loss"] + hist["val_loss"]).all() or (fwd, bwd) != want:
        raise AssertionError(f"fit_device_resident: {state.step} steps, history {hist}, launches {fwd}, {bwd}; "
                             f"expected {steps} steps, launches {want}")

    # the epoch's first minibatch: the indexed step against make_train_step
    order = tr_idx.copy()
    np.random.default_rng(0).shuffle(order)
    data = upload_split(ds, device=device)
    idx = torch.as_tensor(order[:B], device=device)
    a_model, a_state, a_opt = _fresh(device, n_iters, features)
    _, a_loss = make_indexed_train_step(a_model, MultiScaleLoss(), a_opt, data)(a_state, idx)
    b_model, b_state, b_opt = _fresh(device, n_iters, features)
    _, b_loss = make_train_step(b_model, MultiScaleLoss(), b_opt)(b_state, ds.batch(order[:B]))
    first_rel = abs(float(a_loss) - float(b_loss)) / abs(float(b_loss))

    # k fused indexed steps against k single indexed steps, with cuDNN's deterministic algorithms (Adam's first
    # steps move a parameter whose gradient is rounding noise by a whole lr either way, so the atomics of a
    # nondeterministic weight-gradient algorithm alone move it by 2 lr), then a timed fused call
    idxs = torch.as_tensor(order[: k * B].reshape(k, B), device=device)
    with deterministic():
        c_model, c_state, c_opt = _fresh(device, n_iters, features)
        multi = make_indexed_multi_step(c_model, MultiScaleLoss(), c_opt, data)
        c_state, c_loss = multi(c_state, idxs)
        d_model, d_state, d_opt = _fresh(device, n_iters, features)
        single = make_indexed_train_step(d_model, MultiScaleLoss(), d_opt, data)
        d_losses = [single(d_state, i)[1] for i in idxs]
    multi_rel = abs(float(c_loss) - float(torch.stack(d_losses).mean())) / abs(float(c_loss))
    d_params = dict(d_model.named_parameters())
    with torch.no_grad():
        param_lr = max(float((p - d_params[n]).abs().max()) / c_opt.lr for n, p in c_model.named_parameters()
                       if not _zero_grad_param(n))
    finite = all(torch.isfinite(p).all() for p in c_model.parameters())
    same = all(torch.equal(p, d_params[n]) for n, p in c_model.named_parameters())
    # timed outside the deterministic block, after a warm-up call in the same mode: five fused calls, each
    # waited for, as phase 6 (d) waits for each of its steps
    multi(c_state, idxs)
    call_ms = []
    for _ in range(5):
        _sync(device)
        t0 = time.perf_counter()
        c_state, _ = multi(c_state, idxs)
        _sync(device)
        call_ms.append((time.perf_counter() - t0) / k * 1e3)
    multi_ms = float(np.median(call_ms))
    epoch_ms = hist["epoch_time"][0] / steps * 1e3
    print(f"trainers (b) ({device.type}, {card}): fit_device_resident, one epoch of {steps} steps at B={B} on "
          f"{len(ds)} uploaded stamps: train_loss {hist['train_loss'][0]:.6g}, val_loss {hist['val_loss'][0]:.6g}, "
          f"{epoch_ms:.2f} ms per step with validation; solve launches forward {fwd}, backward {bwd}; first step "
          f"vs make_train_step on the same minibatch: loss rel err {first_rel:.3e} (tol {DR_LOSS_REL_TOL}); "
          f"{k} fused steps vs {k} single: mean loss rel err {multi_rel:.3e} (tol {LOSS_REL_TOL}), parameters "
          f"{param_lr:.3e} lr apart (tol {MULTI_PARAM_TOL}; bit-identical: {same}; deterministic cuDNN); fused calls "
          f"of {k} after a warm-up call: " + ", ".join(f"{x:.2f}" for x in call_ms) + f" ms per step (median "
          f"{multi_ms:.2f})")
    if not (first_rel <= DR_LOSS_REL_TOL and multi_rel <= LOSS_REL_TOL and param_lr <= MULTI_PARAM_TOL and finite):
        raise AssertionError("the device-resident steps disagree with the disk step or with each other")
    return {"forward_launches": fwd, "backward_launches": bwd, "epoch_step_ms": epoch_ms, "multi_ms": multi_ms}


def with_signs_of(conics: list, ref: list) -> list:
    """Each (L, B, 6) conic of ``conics`` times -1 where its dot product with
    the same conic of ``ref`` (on the CPU) is negative: the SVD's last right
    singular vector, whose sign no solver fixes, given ``ref``'s signs."""
    return [c * torch.where((c.detach().cpu().to(r.dtype) * r).sum(-1) < 0, -1.0, 1.0).to(c)[..., None]
            for c, r in zip(conics, ref)]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's among them) inside the block,
    a warning naming any operation that has none; the flags restored after."""
    prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def phase_shapenet_and_losses(device, card: str, root: pathlib.Path, save: pathlib.Path, B=TRAIN_BATCH) -> dict:
    """Phase 10 (c): one epoch of ``cli train --model ShapeNet``; the three
    losses and their gradients on the card against the CPU."""
    xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
    state, hist = cli.main(["train", "--model", "ShapeNet", "--data_path", str(root), "--model_save_path", str(save),
                            "--n_epochs", "1", "--batch_size", str(B), "--seed", "0", "--device", device.type])
    _sync(device)
    steps = len(train_val_indices(len(GalaxyDataset(root)), 0.9, 0)[0]) // B
    if state.step != steps or not np.isfinite(hist["train_loss"] + hist["val_loss"]).all():
        raise AssertionError(f"cli train --model ShapeNet: {state.step} steps, history {hist}")
    if xu.x_update_solve.launches or xu.x_update_solve_backward.launches:
        raise AssertionError("cli train --model ShapeNet launched the solve kernels")
    n = _check_checkpoint(state, save, "ShapeNet_Laplacian")
    print(f"trainers (c) ({device.type}, {card}): cli train --model ShapeNet, one epoch of {steps} steps at B={B}: "
          f"train_loss {hist['train_loss'][0]:.6g}, val_loss {hist['val_loss'][0]:.6g}, epoch "
          f"{hist['epoch_time'][0]:.2f} s; checkpoint ShapeNet_Laplacian_1epochs restores {n} tensors bit-exact; "
          "no solve launches")

    gt = GalaxyDataset(root).batch(np.arange(B))["gt"]
    rng = np.random.default_rng(5)
    out = (gt + 0.05 * gt.max(axis=(1, 2), keepdims=True) * rng.standard_normal(gt.shape)).astype(np.float32)
    readings = {}
    for name in ("Shape", "BestEllipse", "MomentBasedLoss"):
        fn, side = build_loss(name), {}
        for key, d in (("cpu", torch.device("cpu")), ("device", device)):
            o = torch.tensor(out, device=d, requires_grad=True)
            t = torch.tensor(gt, device=d)
            if name == "BestEllipse" and key == "device":
                # the card's conics with the CPU's signs: the rest of the loss held as a whole
                value = fn.from_conics(t, *with_signs_of([fn.conics(o), fn.conics(t)], side["cpu"][2]))
            else:
                value = fn(o, t)
            value.backward()
            conics = [fn.conics(x).detach().cpu() for x in (o, t)] if name == "BestEllipse" else None
            side[key] = (value.detach().cpu(), o.grad.cpu(), conics)
        (v_dev, g_dev, c_dev), (v_cpu, g_cpu, c_cpu) = side["device"], side["cpu"]
        grad_rel = float((g_dev - g_cpu).abs().max() / g_cpu.abs().max())
        note = ""
        if name == "BestEllipse":
            # each float32 side against the float64 value on the same inputs, the CPU's signs on every side's conics
            x64 = [torch.tensor(a, dtype=torch.float64) for a in (out, gt)]
            exact = fn.from_conics(x64[1], *with_signs_of([fn.conics(x) for x in x64], c_cpu))
            cpu_rel, value_rel = (float((v - exact).abs() / exact.abs()) for v in (v_cpu, v_dev))
            value_tol, checked = BEST_ELLIPSE_VALUE_REL_TOL, max(cpu_rel, value_rel)
            dots = [(a * b).sum(-1).reshape(-1) for a, b in zip(c_dev, c_cpu)]
            flipped = float(torch.cat(dots).lt(0).float().mean())
            note = (f" (each side against the float64 value; the CPU's against it {cpu_rel:.3e}); the card's "
                    f"conics with the CPU's signs: {flipped:.1%} of the {2 * dots[0].numel()} conics of output and "
                    f"target differ in sign between {device.type} and the CPU, 1 - |c_{device.type} . c_cpu| <= "
                    f"{float(1 - torch.cat(dots).abs().min()):.3e}; with {device.type}'s own signs the value is "
                    f"{float(fn(torch.tensor(out, device=device), torch.tensor(gt, device=device))):.6g} against the "
                    f"CPU's {float(v_cpu):.6g}")
        else:
            value_rel = float((v_dev - v_cpu).abs() / v_cpu.abs())
            value_tol, checked = LOSS_VALUE_REL_TOL, value_rel
        readings[name] = (value_rel, grad_rel)
        print(f"trainers (c) ({device.type}) vs CPU, {name} of {B} gt stamps against a perturbed copy: value rel "
              f"err {value_rel:.3e} (tol {value_tol}){note}; gradient max |d| / max |CPU| {grad_rel:.3e} (tol "
              f"{LOSS_GRAD_TOL})")
        if not (np.isfinite(float(v_dev)) and torch.isfinite(g_dev).all()):
            raise AssertionError(f"{name}: value or gradient not finite on {device.type}")
        if checked > value_tol or grad_rel > LOSS_GRAD_TOL:
            raise AssertionError(f"the {name} loss on {device.type} disagrees with the CPU's")
    return {"readings": readings, "shapenet_epoch_s": hist["epoch_time"][0]}


@contextlib.contextmanager
def recording_steps():
    """``fit``'s train step wrapped: each call's loss (waited for) and host ms,
    call to loss, appended to the list the block yields."""
    from galaxy_deconv_tpu_torch.train import loop

    record, make = [], loop.make_train_step

    def make_recorded(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(state, batch):
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            record.append((float(loss), (time.perf_counter() - t0) * 1e3))
            return state, loss

        return recorded

    with mock.patch.object(loop, "make_train_step", make_recorded):
        yield record


def torchrun(n: int, out: pathlib.Path, backend: str, device: str, jobs: list,
             timeout: float = DP_TIMEOUT_S) -> list[list[dict]]:
    """``torchrun --standalone --nproc_per_node n chip_smoke.py --rank out
    backend device job [--then job ...]`` (:func:`rank_main` in each rank);
    each rank's records, one per job, in rank order.  The launcher and its
    ranks are one process group, killed whole at ``timeout``."""
    out.mkdir(parents=True, exist_ok=True)
    argv = [a for k, job in enumerate(jobs) for a in (["--then"] if k else []) + list(job)]
    run_command([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
                 str(pathlib.Path(__file__).resolve()), "--rank", str(out), backend, device, *map(str, argv)], timeout)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


def run_command(cmd: list, timeout: float) -> tuple[str, str]:
    """``cmd`` from the repository's root in a session of its own, killed
    whole at ``timeout``; its stdout and stderr.  Raises unless it exits 0."""
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{' '.join(cmd)} did not finish in {timeout} s")
    if proc.returncode:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
    return stdout, stderr


def rank_main(argv: list) -> int:
    """One rank of phase 11, started by :func:`torchrun`: ``OUT BACKEND DEVICE
    JOB [--then JOB ...]``.  BACKEND ``gloo`` joins the group over gloo on
    DEVICE first (two ranks sharing one card), ``default`` leaves the group to
    the commands.  A JOB is ``cli <cli arguments>`` (``cli.main``, ``fit``'s
    steps recorded), ``cli-det <cli arguments>`` (the same under
    deterministic algorithms) or ``step ROOT B N_ITERS FEATURES N_STEPS``
    (:func:`dp_steps` on this rank's shard, then the flat gradient's
    all-reduce timed alone).  The rank's records go to OUT/rank<r>.pt."""
    import torch.distributed as dist

    from galaxy_deconv_tpu_torch.parallel import initialize_distributed, make_mesh, shard_batch

    out, backend, device = pathlib.Path(argv[0]), argv[1], argv[2]
    jobs, job = [], []
    for a in argv[3:]:
        if a == "--then":
            jobs, job = jobs + [job], []
        else:
            job.append(a)
    jobs.append(job)
    if backend != "default":
        initialize_distributed(device, backend=backend)
    records = []
    for kind, *rest in jobs:
        xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
        if kind in ("cli", "cli-det"):
            t0 = time.perf_counter()
            with recording_steps() as steps, (deterministic() if kind == "cli-det" else contextlib.nullcontext()):
                cli.main(rest)
            _sync(torch.device(device))
            records.append({"steps": steps, "seconds": time.perf_counter() - t0,
                            "launches": (xu.x_update_solve.launches, xu.x_update_solve_backward.launches)})
            continue
        root, B, n_iters, features, n_steps = rest[0], int(rest[1]), int(rest[2]), rest[3], int(rest[4])
        features = tuple(int(f) for f in features.split(","))
        mesh = make_mesh(None, device)
        batch = shard_batch(GalaxyDataset(root).batch(np.arange(B)), mesh)
        record = dp_steps(mesh.device, batch, n_iters, features, n_steps, mesh)
        # the all-reduce of the flat gradient alone: median of 5 after one
        flat = torch.zeros(sum(p.numel() for p in UnrolledADMMGaussian(n_iters=n_iters, features=features)
                               .parameters()), device=mesh.device)
        times = []
        for _ in range(6):
            dist.barrier()
            _sync(mesh.device)
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            _sync(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        records.append({**record, "all_reduce_ms": float(np.median(times[1:])), "all_reduce_bytes": flat.numel() * 4})
    rank = int(os.environ["RANK"])
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.save(records, out / f"rank{rank}.pt")
    return 0


def dp_steps(device, batch, n_iters, features, n_steps, mesh=None) -> dict:
    """``n_steps`` train steps of a seed-0 model on one batch (this rank's
    shard with ``mesh``), deterministic algorithms on: each step's loss,
    launches and ms; after the first, the gradient (averaged over the ranks
    with ``mesh``) and the BatchNorm statistics; the final parameters."""
    import torch.distributed as dist

    model, state, optimizer = _fresh(device, n_iters, features)
    step = make_train_step(model, MultiScaleLoss(), optimizer, mesh)
    losses, launches, ms, grads, stats = [], [], [], None, None
    with deterministic():
        for k in range(n_steps):
            xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
            _sync(device)
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append((xu.x_update_solve.launches, xu.x_update_solve_backward.launches))
            if k == 0:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                if mesh is not None and mesh.group is not None:
                    for g in grads.values():
                        dist.all_reduce(g, group=mesh.group)
                        g /= mesh.world_size
                grads = {n: g.cpu() for n, g in grads.items()}
                stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running_" in n}
    return {"losses": losses, "launches": launches, "ms": ms, "grads": grads, "stats": stats,
            "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()}}


def _rel(got: dict, want: dict) -> float:
    """The largest max |got - want| / max |want| over the tensors of ``want``."""
    return max(float((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30)) for n, w in want.items())


def _shear_rows_err(res: pathlib.Path, ref: pathlib.Path, method: str, snrs) -> float:
    got, want = (json.loads((d / method / "results.json").read_text()) for d in (res, ref))
    errs = []
    for snr in map(str, snrs):
        g, w = np.asarray(got[snr]["rec_shear"]), np.asarray(want[snr]["rec_shear"])
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{res}/{method} snr {snr}: rec_shear {g.shape} against {w.shape}, or not finite")
        errs.append(float((np.abs(g - w) / (1 + np.abs(w))).max()))
    return max(errs)


def phase_data_parallel(device, card: str, eval_root: pathlib.Path, ref: pathlib.Path, work: pathlib.Path,
                        phase6: dict, B=TRAIN_BATCH, n_stamps=N_STAMPS, n_iters=FLAGSHIP["n_iters"],
                        features=FLAGSHIP["features"], n_steps=DP_STEPS, zero_tol=ZERO_GRAD_TOL,
                        method="Unrolled_ADMM_Gaussian(8)", n_gal=1024, batch=EVAL_BATCH, snrs=SNRS) -> dict:
    """Phase 11, in two launcher calls.  World size 1 over the device's
    default backend (NCCL on the card): (a) ``cli train`` for one epoch on
    phase 6's stamps against phase 6's epoch (both under deterministic
    algorithms), then (c) ``cli test --test shear`` of ``method`` on phase 8's
    tree ``eval_root`` against phase 8's single-device rows in ``ref``.  Two
    ranks over gloo on one device: (b) ``make_train_step(mesh=...)`` on
    shards of B / 2 against one process's steps on the global B, then (c) the
    same sweep at a global batch of two of phase 8's (each rank's shard has
    phase 8's shape)."""
    root = write_dataset(work / "data", n_stamps)
    save = work / "models_dp"
    name = get_model_name("Unrolled_ADMM", "MultiScale", n_iters=n_iters)
    dev = f"{device.type}:0" if device.type == "cuda" else "cpu"

    def sweep(world, global_batch):
        return ["cli", "test", "--n_devices", world, "--data_path", eval_root, "--result_path",
                work / f"results_world{world}", "--methods", method, "--test", "shear", "--n_gal", n_gal,
                "--eval_batch_size", global_batch, "--snrs", *snrs, "--device", dev if world > 1 else device.type]

    t0 = time.perf_counter()
    ((a, c1),) = torchrun(1, work / "world1", "default", device.type, [
        ["cli-det", "train", "--n_devices", 1, "--data_path", root, "--model_save_path", save, "--n_epochs", 1,
         "--batch_size", B, "--n_iters", n_iters, "--seed", 0, "--device", device.type], sweep(1, batch)])
    world1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = torchrun(2, work / "world2", "gloo", dev, [
        ["step", root, B, n_iters, ",".join(map(str, features)), n_steps], sweep(2, 2 * batch)])
    world2_s = time.perf_counter() - t0
    print(f"data parallel ({device.type}, {card}): torchrun --nproc_per_node 1 (default backend, (a) then (c)) "
          f"{world1_s:.1f} s wall, --nproc_per_node 2 (gloo on {dev}, (b) then (c)) {world2_s:.1f} s wall, "
          "torchrun and each rank's start-up included")

    # (a) the world-1 epoch against phase 6's
    hist = json.loads((save / f"{name}_history.json").read_text())
    restored = restore_checkpoint(save, name, 1)
    tr_idx, va_idx = train_val_indices(n_stamps, 0.9, 0)
    steps, val_batches = len(tr_idx) // B, -(-len(va_idx) // B)
    want = (n_iters * (steps + val_batches), n_iters * steps) if device.type == "cuda" else (0, 0)
    losses, ms = np.array([x for x, _ in a["steps"]]), np.array([t for _, t in a["steps"]])
    ref6 = np.array([x for x, _ in phase6["epoch_steps"]])
    ref6_ms = np.array([t for _, t in phase6["epoch_steps"]])
    loss_rel = float(np.abs(losses - ref6).max() / np.abs(ref6).max()) if losses.shape == ref6.shape else float("inf")
    print(f"data parallel (a) ({device.type}, {card}): cli train --n_devices 1 under torchrun, one epoch of "
          f"{len(losses)} steps at B={B}, deterministic algorithms: per-step loss against phase 6's epoch max rel err "
          f"{loss_rel:.3e} (tol {DP_LOSS_REL_TOL}); train_loss {hist['train_loss'][0]:.6g}, val_loss "
          f"{hist['val_loss'][0]:.6g}; solve launches forward {a['launches'][0]}, backward {a['launches'][1]}; ms per "
          f"step (host, call to loss; steps 2-{len(ms)}) median {np.median(ms[1:]):.2f} against phase 6's epoch "
          f"{np.median(ref6_ms[1:]):.2f} (phase 6 (d), not deterministic, {phase6['step_ms']:.2f}); checkpoint step "
          f"{restored['step']}")
    if (len(losses) != steps or restored["step"] != steps or restored["opt_state"]["count"] != steps
            or not np.isfinite(hist["train_loss"] + hist["val_loss"] + losses.tolist()).all()):
        raise AssertionError(f"torchrun cli train: {len(losses)} steps, history {hist}, checkpoint step "
                             f"{restored['step']}; expected {steps} steps")
    if tuple(a["launches"]) != want:
        raise AssertionError(f"torchrun cli train: solve launches {a['launches']}, expected {want}")
    if loss_rel > DP_LOSS_REL_TOL:
        raise AssertionError("the world-1 data-parallel epoch disagrees with phase 6's")

    # (b) two ranks against one process on the global batch
    one = dp_steps(device, GalaxyDataset(root).batch(np.arange(B)), n_iters, features, n_steps)
    r0 = ranks[0][0]
    first_rel = abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    later = [abs(x - y) / abs(y) for x, y in zip(r0["losses"][1:], one["losses"][1:])]
    _, grad_rel, worst, zero = grad_errors(0.0, r0["grads"], 1.0, one["grads"])
    stats_rel = _rel(r0["stats"], one["stats"])
    param_lr = max(float((r0["params"][n] - p).abs().max()) / default_optimizer().lr
                   for n, p in one["params"].items() if not _zero_grad_param(n))
    replicas = all(torch.equal(ranks[1][0]["params"][n], p) for n, p in r0["params"].items())
    per_step = (n_iters, n_iters) if device.type == "cuda" else (0, 0)
    launches_ok = all(tuple(x) == per_step for r in ranks for x in r[0]["launches"])
    print(f"data parallel (b) ({device.type}, {card}): 2 gloo ranks of {B // 2} on {dev} against one process on "
          f"B={B}, {n_steps} steps from seed-0 weights, deterministic algorithms: first loss rel err {first_rel:.3e} "
          f"(tol {DP_LOSS_REL_TOL}); the ranks' averaged first gradient worst rel err {grad_rel:.3e} in {worst} (tol "
          f"{GRAD_REL_TOL}), zero-gradient biases {zero:.3e} of the largest (tol {zero_tol}); running statistics "
          f"after it max rel err {stats_rel:.3e} (tol {DP_STATS_TOL}); the two replicas bit-identical: {replicas}; "
          f"solve launches per step per rank {[[tuple(x) for x in r[0]['launches']] for r in ranks]}; not held (Adam "
          f"moves an entry whose gradient the two summation orders round to opposite signs by 2 lr): later losses' "
          f"rel err " + ", ".join(f"{x:.3e}" for x in later) + f", parameters after {n_steps} steps {param_lr:.3e} lr "
          f"apart; ms per step (steps 2-{n_steps}) ranks {np.median(r0['ms'][1:]):.2f}, one process "
          f"{np.median(one['ms'][1:]):.2f}; gloo all-reduce of the {r0['all_reduce_bytes'] / 1e6:.2f} MB flat "
          f"gradient {r0['all_reduce_ms']:.2f} ms")
    if not (first_rel <= DP_LOSS_REL_TOL and grad_rel <= GRAD_REL_TOL and zero <= zero_tol
            and stats_rel <= DP_STATS_TOL and replicas and launches_ok):
        raise AssertionError("two data-parallel ranks disagree with one process on the global batch")

    # (c) the mesh sweeps against phase 8's single-device rows
    n_iters_m = int(method.rsplit("(", 1)[1].rstrip(")"))
    sweeps = {}
    for world, records, global_batch in ((1, [c1], batch), (2, [r[1] for r in ranks], 2 * batch)):
        err = _shear_rows_err(work / f"results_world{world}", ref, method, snrs)
        want_launches = n_iters_m * -(-n_gal // global_batch) * len(snrs) if device.type == "cuda" else 0
        launches = [r["launches"][0] for r in records]
        rate = n_gal * len(snrs) / max(r["seconds"] for r in records)
        print(f"data parallel (c) ({device.type}, {card}): cli test --n_devices {world} under torchrun "
              f"({'gloo on ' + dev if world > 1 else 'default backend'}), {method} at global B={global_batch} over "
              f"{n_gal} galaxies x {len(snrs)} SNRs: rec_shear against phase 8's single-device rows max |dg| / "
              f"(1 + |g|) {err:.3e} (tol {DP_SHEAR_TOL}); {rate:.1f} gal/s (host clock around the command in the "
              f"slowest rank, model build included); solve launches per rank {launches}")
        if err > DP_SHEAR_TOL or launches != [want_launches] * world:
            raise AssertionError(f"the {world}-rank sweep disagrees with phase 8's, or launched {launches} "
                                 f"(expected {want_launches} per rank)")
        sweeps[world] = {"gal_per_s": rate, "launches": launches, "err": err}
    return {"launches": tuple(a["launches"]), "b_launches": [tuple(map(sum, zip(*r[0]["launches"]))) for r in ranks],
            "sweeps": sweeps, "step_ms": float(np.median(ms[1:])), "phase6_epoch_ms": float(np.median(ref6_ms[1:])),
            "gloo_step_ms": float(np.median(r0["ms"][1:])), "one_step_ms": float(np.median(one["ms"][1:])),
            "all_reduce_ms": r0["all_reduce_ms"], "wall_s": world1_s + world2_s}


def load_script(rel: str):
    """A script of the repository (``scripts/...``, ``examples/...``) as a module; its ``main`` does not run."""
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_bench_line(stdout: str) -> dict:
    """The last line of ``cli bench``'s output: ``bench.py``'s schema, letter
    for letter (``vs_baseline`` is the unrounded rate's ratio, rounded: within
    0.05 of the printed value's ratio, plus 0.05 gal/s of its rounding)."""
    rec = json.loads(stdout.strip().splitlines()[-1])
    if (list(rec) != ["metric", "value", "unit", "vs_baseline"] or rec["metric"] != bench.METRIC
            or rec["unit"] != "gal/s/chip" or not rec["value"] > 0
            or abs(rec["vs_baseline"] - rec["value"] / bench.BASELINE_GAL_PER_SEC)
            > 0.05 + 0.05 / bench.BASELINE_GAL_PER_SEC):
        raise AssertionError(f"cli bench printed {rec}")
    return rec


def phase_measurement(device, card: str, fp32: dict, root: pathlib.Path, models: pathlib.Path, B=BATCH,
                      bench_batches=BENCH_BATCHES, repeats=MEASURE_REPEATS, n_iters=FLAGSHIP["n_iters"],
                      features=FLAGSHIP["features"], mfu_batch=BATCH, probe_batch=256) -> dict:
    """Phase 12, the measurement entry points: (a) ``cli bench`` in each dtype
    at each of ``bench_batches``, a process each; (b) the bench module's timed
    run in this process, fp32 at B, its rows against phase 4's (``fp32``) bit
    for bit and its launches; (c) ``scripts/mfu_torch.py`` in each dtype, timed
    on the card, its FLOP count against the analytic count; (d)
    ``scripts/bench_pipeline_torch.py`` at one batch size on phase 7's tree
    ``root``, one pass, a check that it runs; (e) ``examples/deconv_single_image_torch.py`` with phase 6's
    checkpoint in ``models`` (Richardson-Lucy when it holds none) on ``root``'s
    first test galaxy, on the device against the CPU."""
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    rates = {}
    for dtype in bench.DTYPES:
        for batch in bench_batches:
            stdout, stderr = run_command([sys.executable, "-m", "galaxy_deconv_tpu_torch", "bench", "--batch_size",
                                          str(batch), "--repeats", str(repeats), "--dtype", dtype, "--device",
                                          device.type], COMMAND_TIMEOUT_S)
            rates[(dtype, batch)] = check_bench_line(stdout)["value"]
    print(f"bench (a) ({card}): cli bench, {stderr.splitlines()[0]}, {repeats} calls after a warm-up, host clock "
          "from a synchronised device to the last result on the host, a process each: "
          + ", ".join(f"{dt} B={b} {v:.1f}" for (dt, b), v in rates.items()) + " gal/s; bench.py's schema")

    pipe = bench.bench_pipeline("float32", device, n_iters=n_iters, features=features)
    _sync(device)
    xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
    seconds, rows = bench.timed_run(pipe, bench_inputs(B), repeats)
    _sync(device)
    launches = (xu.x_update_solve.launches, xu.x_update_solve_backward.launches)
    want = (n_iters * (repeats + 1), 0) if cuda else (0, 0)
    same = torch.equal(rows, fp32["shear"])
    print(f"bench (b): the module's timed run in this process, fp32, B={B}: {repeats * B / seconds:.1f} gal/s; "
          f"solve launches forward {launches[0]}, backward {launches[1]} over {repeats + 1} forwards (expected "
          f"{want}); its last rows equal phase 4's bit for bit: {same}")
    if launches != want or not same:
        raise AssertionError("the bench's timed run disagrees with phase 4's pipeline or its launches")

    mfu = load_script("scripts/mfu_torch.py")
    reports, mfu_launches = {}, 0
    for dtype in bench.DTYPES:
        argv = ["--batch", str(mfu_batch), "--repeats", str(repeats), "--dtype", dtype]
        xu.x_update_solve.launches = 0
        reports[dtype] = report = mfu.main(argv if cuda else argv + ["--cpu-flops", "--gal_per_sec", "1"])
        _sync(device)
        mfu_launches += xu.x_update_solve.launches
        if report["conv_matmul_flops_per_galaxy"] != report["analytic_flops_per_galaxy"]:
            raise AssertionError(f"mfu_torch.py counted {report['conv_matmul_flops_per_galaxy']} FLOPs a galaxy, "
                                 f"the layers' shapes give {report['analytic_flops_per_galaxy']}")
    print(f"mfu (c) ({card}): " + "; ".join(
        f"{dt} {r['gal_per_sec']:.1f} gal/s ({r['throughput_source']}), {r['sustained_model_tflops']:.2f} TFLOP/s, "
        f"mfu_vs_dtype_peak {r['mfu_vs_dtype_peak']:.4f} of {r['peak_tflops_dtype_matched']} TFLOP/s"
        for dt, r in reports.items()) + f"; {reports['float32']['conv_matmul_flops_per_galaxy']} FLOPs a galaxy, "
        "equal to the analytic count")

    probe = load_script("scripts/bench_pipeline_torch.py").main(
        ["--data", str(root), "--device", device.type, "--batches", str(probe_batch), "--repeats", str(repeats),
         "--passes", "1"])
    read = probe["read"].get(probe_batch, {})
    if not (probe["simulate"][probe_batch] > 0 and min(read.get("host", [0])) > 0
            and (not cuda or min(read.get("pinned", [0])) > 0)):
        raise AssertionError(f"bench_pipeline_torch.py gave {probe}")

    tutorial = load_script("examples/deconv_single_image_torch.py")
    argv = ["--checkpoint", str(models), "--data_path", str(root)]
    xu.x_update_solve.launches = 0
    got = tutorial.main(argv + ["--device", device.type])
    _sync(device)
    tutorial_launches = xu.x_update_solve.launches
    ref = tutorial.main(argv + ["--device", "cpu"])
    flagship = got["method"].startswith("Unrolled")
    rec_rel = float(np.abs(got["rec"] - ref["rec"]).max() / np.abs(ref["rec"]).max())
    g_err = float((np.abs(got["g_rec"] - ref["g_rec"]) / (1 + np.abs(ref["g_rec"]))).max())
    tol = REC_REL_TOL if flagship else BASELINE_REC_REL_TOL
    print(f"tutorial (e): {got['method']} on {device.type} against the CPU: rec max |d| / max |CPU| {rec_rel:.3e} "
          f"(tol {tol}), shear max |dg| / (1 + |g|) {g_err:.3e} (tol {SHEAR_TOL}); solve launches "
          f"{tutorial_launches}")
    if not (np.isfinite(got["rec"]).all() and np.isfinite(got["g_rec"]).all() and rec_rel <= tol
            and g_err <= SHEAR_TOL and tutorial_launches == (8 if flagship and cuda else 0)):  # its 8 iterations
        raise AssertionError("the tutorial's reconstruction on the device disagrees with the CPU's")
    seconds = time.perf_counter() - t_phase
    print(f"measurement ({card}): phase 12 took {seconds:.1f} s")
    return {"rates": rates, "mfu": reports, "probe": probe, "seconds": seconds,
            "launches": launches[0] + mfu_launches + tutorial_launches, "tutorial": got["method"]}


def _peak_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _numbers(tree) -> list:
    """Every number of a nested report, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _numbers(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _numbers(v)]
    return [float(tree)] if isinstance(tree, (int, float)) else []


def _block(text: str, tag: str) -> str:
    """What sits between a RESULTS.md's ``<!-- tag START/END -->`` markers."""
    return text.split(f"<!-- {tag} START -->", 1)[1].split(f"<!-- {tag} END -->", 1)[0]


# phase 13's widths and sizes on the card (PERF.md section 4); tests/test_torch_port_rules.py gives the CPU its own.
# "sim" overrides SimulationConfig's fields, "sharded" is (n_train, n_test, chunk), "n_gal" the galaxies of
# run_benchmark_torch and cli test, "trace_batch" rho_trace_torch's batch on the card and on the CPU.
SCRIPT_SIZES = {
    "features": FLAGSHIP["features"], "denoiser_features": (64, 128, 256, 512), "sim": {}, "train_batch": TRAIN_BATCH,
    "n_stamps": 512, "sharded": (64, 256, 64), "n_gal": 64, "eval_batch": 250, "profile_batch": BATCH,
    "profile_repeats": 5, "reconcile_n_gal": 512, "trace_batch": 32, "cross_n_gal": 128, "pop_n_gal": 128}


def phase_scripts(device, card: str, fp32: dict, root: pathlib.Path, models: pathlib.Path, work: pathlib.Path,
                  sizes: dict = SCRIPT_SIZES) -> dict:
    """Phase 13, the scripts of ``scripts/*_torch.py`` on phase 7's tree
    ``root``, with phase 6's checkpoint in ``models`` and phase 4's fp32 rows
    ``fp32``; every output under ``work``.  ``sizes`` gives the widths, the
    simulator's overrides and the sizes (:data:`SCRIPT_SIZES` on the card)."""
    t_phase = time.perf_counter()
    cuda, dev, n8 = device.type == "cuda", device.type, FLAGSHIP["n_iters"]
    flagship_run = get_model_name("Unrolled_ADMM", "MultiScale", n_iters=n8)
    launches = {"forward": 0, "backward": 0}

    def counted(fn, *args, **kwargs):
        """``fn``'s result and its solve launches (forward, backward), added to the phase's."""
        xu.x_update_solve.launches = xu.x_update_solve_backward.launches = 0
        out = fn(*args, **kwargs)
        _sync(device)
        got = (xu.x_update_solve.launches, xu.x_update_solve_backward.launches)
        launches["forward"] += got[0]
        launches["backward"] += got[1]
        return out, got

    def expect(what: str, got: tuple, forward: int, backward: int = 0) -> None:
        want = (forward, backward) if cuda else (0, 0)
        if got != want:
            raise AssertionError(f"{what}: solve launches {got}, expected {want}")

    def script(name: str):
        """The script as a module, at this phase's widths and optics."""
        mod = load_script(f"scripts/{name}.py")
        for attr, key in (("FEATURES", "features"), ("DENOISER_FEATURES", "denoiser_features")):
            if hasattr(mod, attr):
                setattr(mod, attr, tuple(sizes[key]))
        if sizes["sim"] and hasattr(mod, "SimulationConfig"):
            mod.SimulationConfig = functools.partial(sim.SimulationConfig, **sizes["sim"])
        return mod

    narrow = tuple(sizes["features"]) != FLAGSHIP["features"]
    with contextlib.ExitStack() as stack:
        if narrow:  # the flagship by harness name at this phase's widths
            stack.enter_context(mock.patch.dict(registry.MODEL_REGISTRY, {
                "Unrolled_ADMM_Gaussian": functools.partial(UnrolledADMMGaussian, features=tuple(sizes["features"]))}))

        # (a) the zoo's online training: ADMM(2) and the ResUNet denoiser, validation every 2 steps
        tz, zoo, steps, tb = script("train_zoo_torch"), work / "zoo", 4, sizes["train_batch"]
        with mock.patch.object(tz, "VAL_EVERY", 2):
            _, got = counted(tz.main, ["--models", "admm2", "resunet", "--steps", str(steps), "--steps_per_call", "2",
                                       "--batch", str(tb), "--save_path", str(zoo), "--device", dev])
        hists = {}
        for key in ("admm2", "resunet"):
            name = tz.SPECS[key][0]
            hists[key] = h = json.loads((zoo / f"{name}_history.json").read_text())
            if not (h["step"] == [2, 4] and np.isfinite(h["train_loss"] + h["val_loss"]).all()
                    and best_epoch(zoo, name) == h["best_step"] and checkpoint_steps(zoo, name) >= {h["best_step"], 4}):
                raise AssertionError(f"train_zoo_torch {key}: history {h}, checkpoints {checkpoint_steps(zoo, name)}")
        val_batches = 4  # fit_online's default
        print(f"scripts (a) ({dev}): train_zoo_torch admm2 + resunet, {steps} steps of {tb} in calls of 2, validation "
              f"every 2 steps: " + "; ".join(f"{k} train {h['train_loss']} val {h['val_loss']} best step "
                                             f"{h['best_step']} ({h['galaxies_per_sec']:.1f} gal/s)"
                                             for k, h in hists.items()) + f"; solve launches {got}")
        expect("train_zoo_torch", got, 2 * (steps + 2 * val_batches), 2 * steps)

        # (b) export, then the method matrix against cli test of the same checkpoint
        exported, res, cli_res = work / "exported", work / "results", work / "cli_results"
        load_script("scripts/export_trained_torch.py").main(["--src", str(zoo), "--dst", str(exported)])
        rb, admm2 = script("run_benchmark_torch"), tz.SPECS["admm2"][0]
        n_gal, eb = sizes["n_gal"], sizes["eval_batch"]
        _, got = counted(rb.main, ["--ckpt", str(exported), "--trained", str(work / "no_trained"), "--data", str(root),
                                   "--result", str(res), "--n_gal", str(n_gal), "--batch", str(eb), "--only",
                                   "No_Deconv", "Unrolled_ADMM_Gaussian(2)", "--skip_psf", "--skip_psnr",
                                   "--device", dev])
        # the shear sweep's batches, then the time sweep's: a warm-up batch and 3 timed sweeps of whole batches
        expect("run_benchmark_torch", got, 2 * (len(SNRS) * -(-n_gal // eb) + 1 + 3 * max(1, n_gal // eb)))
        _, got_cli = counted(cli.main, ["test", "--data_path", str(root), "--result_path", str(cli_res), "--n_gal",
                                        str(n_gal), "--eval_batch_size", str(eb), "--methods",
                                        "Unrolled_ADMM_Gaussian(2)", "--model_save_path", str(exported),
                                        "--checkpoint_name", admm2, "--device", dev])
        expect("cli test", got_cli, 2 * len(SNRS) * -(-n_gal // eb))
        a, c = (json.loads((r / "Unrolled_ADMM_Gaussian(2)" / "results.json").read_text()) for r in (res, cli_res))
        same = all(a[str(snr)]["rec_shear"] == c[str(snr)]["rec_shear"] for snr in SNRS)
        table = _block((res / "RESULTS.md").read_text(), "BENCHMARK TABLE")
        rows_ok = "| No_Deconv |" in table and "| Unrolled_ADMM_Gaussian(2) |" in table
        print(f"scripts (b) ({dev}): export_trained_torch + run_benchmark_torch, No_Deconv and "
              f"Unrolled_ADMM_Gaussian(2) over {n_gal} galaxies x {len(SNRS)} SNRs at B={eb}: shear rows equal to cli "
              f"test's of the same checkpoint bit for bit: {same}; RESULTS.md's benchmark table between its markers "
              f"with both rows: {rows_ok}; solve launches {got}, cli test {got_cli}")
        if not (same and rows_ok):
            raise AssertionError("run_benchmark_torch disagrees with cli test, or its tables are missing")

        # (c) the reference protocol: 2 epochs of a fixed dataset, the save rule and best_epoch
        rp, rp_save = script("reference_protocol_torch"), work / "refproto"
        run = "RefProto_Gaussian_PnP_ADMM_2iters_MultiScale"
        n_stamps, spc = sizes["n_stamps"], 4
        _, got = counted(rp.main, ["--models", "2", "--epochs", "2", "--n_stamps", str(n_stamps), "--batch", str(tb),
                                   "--split", "0.5", "--steps_per_call", str(spc), "--chunk", str(n_stamps),
                                   "--save_path", str(rp_save), "--out", str(work / "refproto.json"), "--device", dev])
        rep = json.loads((work / "refproto.json").read_text())["runs"][run]
        saved, best = rp.saved_epochs(rep["val_loss"])
        on_disk = sorted(checkpoint_steps(rp_save, run))
        print(f"scripts (c) ({dev}): reference_protocol_torch, 2 epochs of {n_stamps} stamps (split 0.5, B={tb}): "
              f"train {rep['train_loss']} val {rep['val_loss']}; checkpoints {on_disk}, the save rule's {saved}; best "
              f"epoch {rep['best_epoch']}, best_epoch() {best_epoch(rp_save, run)}; solve launches {got}")
        if not (np.isfinite(rep["train_loss"] + rep["val_loss"]).all() and on_disk == saved
                and rep["best_epoch"] == best == best_epoch(rp_save, run)):
            raise AssertionError("reference_protocol_torch's checkpoints or history disagree with its save rule")
        steps_ep, val_b = (n_stamps // 2) // tb // spc * spc, (n_stamps - n_stamps // 2) // (8 * tb)
        expect("reference_protocol_torch", got, 2 * 2 * (steps_ep + val_b), 2 * 2 * steps_ep)

        # (d) sharded generation against generate_dataset
        gs, (n_tr, n_te, chunk) = script("generate_sharded_torch"), sizes["sharded"]
        common = ["--root", str(work / "sharded"), "--n_train", str(n_tr), "--n_test", str(n_te), "--chunk",
                  str(chunk), "--device", dev]
        t0 = time.perf_counter()
        for shard in (0, 1):
            gs.main(["worker", "--shard", str(shard), "--n_shards", "2", *common])
        gs.main(["merge", *common])
        sharded_s = time.perf_counter() - t0
        direct = generate_dataset(work / "direct", n_train=n_tr, n_test=n_te, chunk=chunk, seed=31415,
                                  cfg=sim.SimulationConfig(**sizes["sim"]), verbose=False, device=device)
        files = sorted(str(f.relative_to(direct)) for f in direct.rglob("*") if f.is_file())
        made = sorted(str(f.relative_to(work / "sharded")) for f in (work / "sharded").rglob("*")
                      if f.is_file() and "_shards" not in f.parts)
        differ = [f for f in files if (direct / f).read_bytes() != (work / "sharded" / f).read_bytes()]
        print(f"scripts (d) ({dev}): generate_sharded_torch, 2 workers + merge, {n_tr} train + {n_te} test in chunks "
              f"of {chunk} with every PSF set ({sharded_s:.2f} s): {len(files)} files against generate_dataset's, "
              f"same names {made == files}, byte-identical except {differ}")
        if made != files or differ:
            raise AssertionError("the sharded tree differs from generate_dataset's")

        # (e) the op profile (fp32: its full rows against phase 4's) and the throughput reconciliation
        po, pb, reps = script("profile_ops_torch"), sizes["profile_batch"], sizes["profile_repeats"]
        _, got = counted(po.main, ["--batch", str(pb), "--repeats", str(reps), "--dtype", "float32", "--out",
                                   str(work / "op_profile.json"), "--device", dev])
        loop = po.LOOPS[0]
        expect("profile_ops_torch", got, n8 * (4 * (reps + 1) + 1 + max(reps // loop, 3) * loop))
        prof = json.loads((work / "op_profile.json").read_text())
        pipe = bench.bench_pipeline("float32", device, features=tuple(sizes["features"]))
        comps = po.components(pipe, *(torch.as_tensor(a, device=device) for a in bench_inputs(pb)), torch.float32)
        with torch.inference_mode(), fp32_only():
            same_full = torch.equal(comps["full"][0]().cpu(), fp32["shear"])
            _, fft_got = counted(comps["fftpath_fft"][0])
        t = prof["timings_ms"]
        print(f"scripts (e) ({dev}, {card}): profile_ops_torch fp32 B={pb}, {reps} calls each ({prof['clock']}): "
              + ", ".join(f"{name} {v['ms_per_call']:.3f}" for name, v in t.items()) + f" ms; dispatch overhead "
              f"{prof['dispatch_overhead_ms']:.3f} ms; full rows equal phase 4's bit for bit: {same_full}; solve "
              f"launches {got}, one fftpath call {fft_got}")
        expect("fftpath", fft_got, n8)
        if not same_full:
            raise AssertionError("profile_ops_torch's full pipeline disagrees with phase 4's")
        rt = script("reconcile_throughput_torch")
        src, ep = find_checkpoint(flagship_run, models)
        sd8 = unpack_variables(restore_checkpoint(src, flagship_run, ep))
        (rows, shears), got = counted(rt.reconcile, sd8, root, sizes["reconcile_n_gal"], device)
        ga, gb = shears["A_eval_harness_fp32_b250"], shears["B_plus_batch256"]
        k = min(len(ga), len(gb))
        ab_err = float((np.abs(ga[:k] - gb[:k]) / (1 + np.abs(gb[:k]))).max())
        print(f"scripts (e) ({dev}, {card}): reconcile_throughput_torch with phase 6's checkpoint over "
              f"{sizes['reconcile_n_gal']} galaxies: "
              + ", ".join(f"{label} {v['gal_per_sec']:.1f}" for label, v in rows.items())
              + f" gal/s; A against B on {k} galaxies max |dg| / (1 + |g|) {ab_err:.3e} (tol {SCRIPT_SHEAR_TOL}), "
              f"max |dg| / max |g| {_peak_rel(ga[:k], gb[:k]):.3e}; solve launches {got}")
        if ab_err > SCRIPT_SHEAR_TOL:
            raise AssertionError("reconcile's fp32 configurations A and B disagree")

        # (f) scaling: under torchrun at world size 1 on the card (NCCL), alone on the CPU
        argv = ["--steps", "3", "--n_iters", "2", "--per_device_batch", str(tb), "--device", dev]
        if cuda:
            stdout, _ = run_command([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                     "1", str(REPO / "scripts" / "scaling_torch.py"), *argv], DP_TIMEOUT_S)
        else:
            buf = __import__("io").StringIO()
            with contextlib.redirect_stdout(buf):
                script("scaling_torch").main(argv)
            stdout = buf.getvalue()
        m = re.search(r"^1 device\(s\): (\d+) gal/s train", stdout, re.M)
        print(f"scripts (f) ({dev}): scaling_torch: " + " | ".join(stdout.strip().splitlines()))
        if m is None or not int(m.group(1)) > 0:
            raise AssertionError(f"scaling_torch printed {stdout!r}")

        # (g) the science scripts: card against CPU
        rho, n_trace = script("rho_trace_torch"), sizes["trace_batch"]
        got_rep, got = counted(rho.trace_report, root, n_trace, zoo, models, device)
        ref_rep = rho.trace_report(root, n_trace, zoo, models, "cpu")
        rho_err = {lab: max(_peak_rel(st[key], ref_rep["models"][lab][key]) for key in
                            ("rho_q10", "rho_median", "rho_q90", "rel_z_change_median"))
                   for lab, st in got_rep["models"].items()}
        expect("rho_trace_torch", got, n8 + 2)
        mf = script("make_figures_torch")
        sd_fig = unpack_variables(restore_checkpoint(models, mf.FLAGSHIP_RUN, latest_epoch(models, mf.FLAGSHIP_RUN)))
        arrays, got_mf = counted(mf.model_arrays, sd_fig, root, 100, device)
        ref_arrays = mf.model_arrays(sd_fig, root, 100, "cpu")
        trace_err = {f: _peak_rel(arrays["traces"][f], ref_arrays["traces"][f]) for f in ("x", "z", "u", "rho")}
        expect("make_figures_torch", got_mf, n8)
        ce, cn = script("cross_estimator_torch"), sizes["cross_n_gal"]
        snrs = [20, 100, 200]
        got_ce, ref_ce = (ce.cross_report(root, cn, snrs, d) for d in (device, "cpu"))
        g_num, r_num = np.array(_numbers(got_ce)), np.array(_numbers(ref_ce))
        ce_err = float((np.abs(g_num - r_num) / (1 + np.abs(r_num))).max())
        ps = script("population_sweep_torch")
        _, got_ps = counted(ps.main, ["--n_gal", str(sizes["pop_n_gal"]), "--chunk", str(sizes["pop_n_gal"]),
                                      "--configs", "default", "clumpy", "--trained", str(models), "--out",
                                      str(work / "population.json"), "--device", dev])
        pop = json.loads((work / "population.json").read_text())
        expect("population_sweep_torch", got_ps, n8 * 2 * 2)
        print(f"scripts (g) ({dev}): rho_trace_torch on {n_trace} test galaxies, card against CPU, max |d| / max |CPU| "
              + ", ".join(f"{label} {v:.3e}" for label, v in rho_err.items())
              + f" (tol {REC_REL_TOL}); make_figures_torch's trace arrays "
              + ", ".join(f"{f} {v:.3e}" for f, v in trace_err.items()) + f" (tol {REC_REL_TOL}); "
              f"cross_estimator_torch on {cn} galaxies at SNR {snrs}: every statistic max |d| / (1 + |CPU|) "
              f"{ce_err:.3e} (tol {SCRIPT_STAT_TOL}); population_sweep_torch: " + "; ".join(
                  f"{name} distance {v['fingerprint_dist']:.3f}" for name, v in pop["configs"].items())
              + f"; solve launches rho {got}, figures {got_mf}, population {got_ps}")
        if not (set(got_rep["models"]) == {"Unrolled_ADMM_Gaussian(8)", "Unrolled_ADMM_Gaussian(2)"}
                and max(rho_err.values()) <= REC_REL_TOL and max(trace_err.values()) <= REC_REL_TOL
                and ce_err <= SCRIPT_STAT_TOL and np.isfinite(_numbers(pop["configs"])).all()):
            raise AssertionError("the science scripts on the device disagree with the CPU, or found no checkpoint")
    seconds = time.perf_counter() - t_phase
    print(f"scripts ({card}): phase 13 took {seconds:.1f} s; solve launches forward {launches['forward']}, backward "
          f"{launches['backward']}")
    return {"seconds": seconds, "launches": launches, "ab_err": ab_err, "profile": prof, "reconcile": rows}


def _shear_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"shears of shape {got.shape} (want {want.shape}), finite {np.isfinite(got).all()}")
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def phase_trained(device, card: str, root: pathlib.Path, seed0: pathlib.Path, work: pathlib.Path,
                  n_golden: int = 64, n_gal: int = 1024, batch: int = EVAL_BATCH, snrs=SNRS) -> dict:
    """Phase 14, the JAX package's trained flagship from ``trained_port/``:
    (a) restored through the port's checkpoint path into ``build_pipeline``;
    (b) fp32 with shear on the first ``n_golden`` golden stamps against the JAX
    package's outputs, and a TF32 control; (c) bf16 against JAX's bf16; (d) the
    goldens as a COSMOS-layout tree (``generate_galsim.write_packed_dataset``)
    through ``cli test``, and ``generate_galsim.observe`` on the device against
    the CPU; (e) the ``cli test`` shear sweep on phase 7's tree ``root``, its
    median |g - g_true| per SNR beside the seed-0 flagship's in phase 8's
    results ``seed0``.  Outputs under ``work``."""
    t_phase = time.perf_counter()
    cuda, dev, method = device.type == "cuda", device.type, "Unrolled_ADMM_Gaussian(8)"
    per_forward = FLAGSHIP["n_iters"] if cuda else 0
    launches = {}

    # (a) the checkpoint, never seed weights in its place
    epoch = best_epoch(TRAINED_DIR, TRAINED_RUN)
    if not epoch:
        raise FileNotFoundError(f"no checkpoint of {TRAINED_RUN} under {TRAINED_DIR}")
    sd = unpack_variables(restore_checkpoint(TRAINED_DIR, TRAINED_RUN, epoch))
    pipe = build_pipeline(device, state_dict=sd)
    loaded = {k: v.cpu() for k, v in pipe.model.state_dict().items()}
    if loaded.keys() != sd.keys() or not all(torch.equal(loaded[k], sd[k]) for k in sd):
        raise AssertionError("the pipeline's tensors differ from the checkpoint file's")
    g = np.load(TRAINED_DIR / "flagship_goldens.npz")
    if str(g["checkpoint"]) != f"{TRAINED_RUN}_{epoch}epochs":
        raise AssertionError(f"the goldens are of {g['checkpoint']}, the checkpoint is epoch {epoch}")
    gold = {k: g[k][:n_golden] for k in ("obs", "psf", "gt", "alpha", "rec", "shear", "rec_bf16", "shear_bf16")}
    n_params = sum(t.numel() for k, t in sd.items() if "running_" not in k and "num_batches" not in k)
    print(f"trained (a): {TRAINED_RUN} epoch {epoch} from {TRAINED_DIR.name}/, {n_params:,} parameters and "
          f"{len(sd)} tensors, the pipeline's equal to the file's; goldens: {n_golden} stamps")

    # (b) fp32 with shear against the JAX package's
    inputs = [gold[k] for k in ("obs", "psf", "alpha")]
    xu.x_update_solve.launches = 0
    rec = pipe.reconstruct(*inputs)
    shear = estimate_shear(rec)
    _sync(device)
    launches["fp32"] = xu.x_update_solve.launches
    rec, shear = rec.cpu(), shear.cpu()
    rec_rel, shear_err = _peak_rel(rec, gold["rec"]), _shear_err(shear, gold["shear"])
    print(f"trained (b) ({dev}): fp32 against the JAX package's goldens: rec max |d| / max |JAX| {rec_rel:.3e} "
          f"(tol {TRAINED_REC_REL_TOL}), g max |dg| / (1 + |g|) {shear_err:.3e} (tol {TRAINED_SHEAR_TOL}); "
          f"x_update_solve launches per forward {launches['fp32']}")
    if launches["fp32"] != per_forward:
        raise AssertionError(f"x_update_solve launched {launches['fp32']} times in one forward, expected {per_forward}")
    if not (rec_rel <= TRAINED_REC_REL_TOL and shear_err <= TRAINED_SHEAR_TOL):
        raise AssertionError("the trained flagship disagrees with the JAX package's goldens")
    if cuda:
        # the control bypasses Pipeline, whose calls turn TF32 off
        with tf32_on(), torch.inference_mode():
            tf32_rec = pipe.model(*(torch.as_tensor(a, device=device) for a in inputs)).cpu()
        tf32_rel = _peak_rel(tf32_rec, gold["rec"])
        print(f"trained (b) control: the model called directly with TF32 on: rec max |d| / max |JAX| {tf32_rel:.3e} "
              f"(must exceed the tol {TRAINED_REC_REL_TOL})")
        if tf32_rel <= TRAINED_REC_REL_TOL:
            raise AssertionError("the trained reconstruction check cannot tell a TF32 run from an fp32 one")

    # (c) bf16 nets against the JAX package's bf16 nets
    pipe_bf16 = build_pipeline(device, dtype=torch.bfloat16, state_dict=sd)
    xu.x_update_solve.launches = 0
    rec_bf16 = pipe_bf16.reconstruct(*inputs).float()
    shear_bf16 = estimate_shear(rec_bf16)
    _sync(device)
    launches["bf16"] = xu.x_update_solve.launches
    bf16_rel = _peak_rel(rec_bf16.cpu(), gold["rec_bf16"])
    bf16_dg = float(np.abs(shear_bf16.cpu().numpy() - gold["shear_bf16"]).max())
    print(f"trained (c) ({dev}): bf16 nets against the JAX package's bf16 goldens: rec max |d| / max |JAX| "
          f"{bf16_rel:.3e} (tol {TRAINED_BF16_REL_TOL}), g max |dg| {bf16_dg:.3e} (printed, not held); x_update_solve "
          f"launches {launches['bf16']}")
    if launches["bf16"] != per_forward or not bf16_rel <= TRAINED_BF16_REL_TOL:
        raise AssertionError("the trained flagship's bf16 nets disagree with the JAX package's")

    # (d) the COSMOS layout through cli test, and observe on the device against the CPU
    stamps = {k: list(gold[k]) for k in ("obs", "psf", "gt")}
    meta = dict(n_train=n_golden, n_test=n_golden, fov_pixels=48, pixel_scale=0.2, upsample=4, seed=int(g["seed"]),
                snrs=[COSMOS_SNR], shear_errs=[], fwhm_errs=[], generator="galsim/COSMOS")
    cosmos = write_packed_dataset(work / "cosmos", {"train": stamps, "test": stamps},
                                  {f"obs_{COSMOS_SNR}": stamps["obs"], f"gt_{COSMOS_SNR}": stamps["gt"]}, {}, meta)
    ckpt = ["--model_save_path", str(TRAINED_DIR), "--checkpoint_name", TRAINED_RUN]
    xu.x_update_solve.launches = 0
    rows = cli.main(["test", "--test", "shear", "--methods", method, *ckpt, "--data_path", str(cosmos), "--result_path",
                     str(work / "cosmos_results"), "--n_gal", str(n_golden), "--eval_batch_size", str(n_golden),
                     "--snrs", str(COSMOS_SNR), "--device", dev])[method][str(COSMOS_SNR)]["rec_shear"]
    _sync(device)
    launches["cosmos"] = xu.x_update_solve.launches
    cosmos_err = _shear_err(rows, gold["shear"])
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:192, :192] - 95.5
    gal = np.exp(-(xx**2 / 2 / 14**2 + yy**2 / 2 / 9**2 + 0.3 * xx * yy / 14 / 9)).astype(np.float32)
    psf_hi = np.exp(-(xx**2 + yy**2) / 2 / 6**2) * (1 + 0.1 * rng.random((192, 192)))
    psf_hi = (psf_hi / psf_hi.sum()).astype(np.float32)
    got, want = (observe(gal, psf_hi, sim.noise_sigma(), 50.0, np.random.default_rng(7), device=d)
                 for d in (device, "cpu"))
    observe_rel = max(_peak_rel(a.cpu(), b) for a, b in zip(got, want))
    print(f"trained (d) ({dev}): cli test --test shear --checkpoint_name {TRAINED_RUN} on the goldens written as a "
          f"COSMOS-layout tree (generator galsim/COSMOS, variant obs_{COSMOS_SNR}): rows against the JAX package's "
          f"max |dg| / (1 + |g|) {cosmos_err:.3e} (tol {TRAINED_SHEAR_TOL}), x_update_solve launches "
          f"{launches['cosmos']}; generate_galsim.observe of a 192x192 galaxy on {dev} against the CPU max |d| / "
          f"max |CPU| {observe_rel:.3e} (tol {OBSERVE_REL_TOL})")
    if launches["cosmos"] != per_forward or cosmos_err > TRAINED_SHEAR_TOL:
        raise AssertionError("cli test of the trained checkpoint on the COSMOS-layout tree disagrees with the goldens")
    if observe_rel > OBSERVE_REL_TOL:
        raise AssertionError("generate_galsim.observe on the device disagrees with the CPU")

    # (e) the science of the trained weights on phase 7's tree, beside phase 8's seed-0 flagship
    xu.x_update_solve.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    trained = cli.main(["test", "--test", "shear", "--methods", method, *ckpt, "--data_path", str(root),
                        "--result_path", str(work / "sweep"), "--n_gal", str(n_gal), "--eval_batch_size", str(batch),
                        "--snrs", *map(str, snrs), "--device", dev])[method]
    _sync(device)
    sweep_s = time.perf_counter() - t0
    launches["sweep"] = xu.x_update_solve.launches
    if launches["sweep"] != per_forward * len(snrs) * -(-n_gal // batch):
        raise AssertionError(f"the trained sweep launched x_update_solve {launches['sweep']} times")
    truth = json.loads((seed0 / "No_Deconv" / "results.json").read_text())
    seed0_rows = json.loads((seed0 / method / "results.json").read_text())
    medians = {snr: (harness.median_ellipticity_error(trained, truth, snr),
                     harness.median_ellipticity_error(seed0_rows, truth, snr)) for snr in snrs}
    seconds = time.perf_counter() - t_phase
    print(f"trained (e) ({dev}, {card}): cli test --test shear of the trained flagship on phase 7's tree, {n_gal} "
          f"galaxies x {len(snrs)} SNRs at B={batch}: {len(snrs) * n_gal / sweep_s:.1f} gal/s, x_update_solve launches "
          f"{launches['sweep']}; median |g - g_true| per SNR, trained / seed-0 (phase 8): "
          + ", ".join(f"{snr} {a:.4f} / {b:.4f}" for snr, (a, b) in medians.items()))
    print(f"trained ({card}): phase 14 took {seconds:.1f} s; x_update_solve launches {sum(launches.values())}")
    return {"seconds": seconds, "launches": sum(launches.values()), "rec_rel": rec_rel, "shear_err": shear_err,
            "bf16_rel": bf16_rel, "cosmos_err": cosmos_err, "medians": medians}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_name_and_power_limit()
    print(f"device: {kind}; count {torch.cuda.device_count()}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    kernel = phase_kernel_x_update_solve(device)
    kernel_bwd = phase_kernel_x_update_solve_backward(device, card)

    fp32 = phase_pipeline_fp32(device, repeats=10)
    bf16 = phase_pipeline_bf16(device, fp32, repeats=10)
    print(f"throughput ({card}): fp32 {fp32['gal_per_s']:.1f} gal/s, bf16 {bf16['gal_per_s']:.1f} gal/s "
          f"(B={BATCH}, 10 forwards + shear each, host clock around torch.cuda.synchronize())")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        models = pathlib.Path(tmp) / "models"  # phase 6's checkpoint, for phase 12's tutorial
        train = phase_train_fp32(device, save=models)
        print(f"training ({card}): fp32, TF32 off, B={train['batch']}: {train['step_ms']:.2f} ms per train step, "
              f"{train['gal_per_s']:.1f} gal/s (median of {train['timed_steps']} steps after warm-up, host clock "
              f"around torch.cuda.synchronize())")
        gen = phase_generate(device, pathlib.Path(tmp) / "data")
        test = phase_test(device, pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "results", card)
        zoo = phase_zoo(device, pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "zoo", card)
        dp = phase_data_parallel(device, card, pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "results",
                                 pathlib.Path(tmp) / "dp", train)
        measure = phase_measurement(device, card, fp32, pathlib.Path(tmp) / "data", models)
        scripts = phase_scripts(device, card, fp32, pathlib.Path(tmp) / "data", models, pathlib.Path(tmp) / "scripts")
        trained = phase_trained(device, card, pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "results",
                                pathlib.Path(tmp) / "trained")
    print(f"evaluation ({card}): cli generate {gen['gal_per_s']:.1f} gal/s ({gen['scenes_per_s']:.1f} scenes/s); "
          f"cli test flagship shear sweep {test['rates'][('Unrolled_ADMM_Gaussian(8)', 'shear')]:.1f} gal/s; "
          "zoo shear sweeps " + ", ".join(f"{k} {v:.1f}" for k, v in zoo["rates"].items()) + " gal/s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainers_") as tmp:
        root = write_dataset(pathlib.Path(tmp) / "data")
        online = phase_online(device, card, pathlib.Path(tmp) / "online")
        resident = phase_device_resident(device, card, root)
        shapes = phase_shapenet_and_losses(device, card, root, pathlib.Path(tmp) / "shapenet")
    print(f"trainers ({card}): fp32, TF32 off, B={TRAIN_BATCH}: online {online['step_ms']:.2f} ms per step "
          f"({TRAIN_BATCH / online['step_ms'] * 1e3:.1f} gal/s; the simulator {online['render_ms']:.2f} ms of it; peak "
          f"{online['peak_gib']:.2f} GiB); device-resident {resident['multi_ms']:.2f} ms per step in fused calls of "
          f"4 (median of 5), {resident['epoch_step_ms']:.2f} ms per step over its epoch with validation; the disk "
          f"step of phase 6 {train['step_ms']:.2f} ms; ShapeNet's epoch {shapes['shapenet_epoch_s']:.2f} s")
    print(f"data parallel ({card}): fp32, TF32 off, deterministic algorithms: cli train at world 1 "
          f"{dp['step_ms']:.2f} ms per step against phase 6's epoch {dp['phase6_epoch_ms']:.2f}; two gloo ranks on one "
          f"card {dp['gloo_step_ms']:.2f} ms per step against one process's {dp['one_step_ms']:.2f} (the all-reduce of "
          f"the flat gradient {dp['all_reduce_ms']:.2f} ms); the flagship's shear sweep at world 1 "
          f"{dp['sweeps'][1]['gal_per_s']:.1f} gal/s, over two gloo ranks {dp['sweeps'][2]['gal_per_s']:.1f}; phase 11 "
          f"{dp['wall_s']:.1f} s in its two launcher calls")
    print(f"measurement ({card}): cli bench "
          + ", ".join(f"{dt} B={b} {v:.1f}" for (dt, b), v in measure["rates"].items()) + " gal/s; mfu_vs_dtype_peak "
          + ", ".join(f"{dt} {r['mfu_vs_dtype_peak']:.4f}" for dt, r in measure["mfu"].items())
          + f"; phase 12 {measure['seconds']:.1f} s")
    timings = scripts["profile"]["timings_ms"]
    print(f"scripts ({card}): op profile fp32 B={BATCH} full {timings['full']['ms_per_call']:.3f} ms, loop8 "
          f"{timings['loop8']['ms_per_call']:.3f} ms a call; reconcile "
          + ", ".join(f"{k} {v['gal_per_sec']:.1f}" for k, v in scripts["reconcile"].items())
          + f" gal/s; phase 13 {scripts['seconds']:.1f} s")
    print(f"trained flagship ({card}): against the JAX package's goldens rec {trained['rec_rel']:.3e}, g "
          f"{trained['shear_err']:.3e} (1 + |g|), bf16 rec {trained['bf16_rel']:.3e}, the COSMOS-layout cli test's g "
          f"{trained['cosmos_err']:.3e}; phase 14 {trained['seconds']:.1f} s")
    # the main paths' runs: one fp32 pipeline forward, the cli's epoch of training, the flagship's eval sweeps,
    # the online run, the device-resident epoch, phase 11's data-parallel epoch, steps and sweeps (each rank's),
    # phase 12's in-process bench run, MFU reports and tutorial, phase 13's scripts in this process, and phase 14's
    # trained forwards and sweeps
    kernel["launches"] = (fp32["launches"] + train["forward_launches"] + test["launches"]["Unrolled_ADMM_Gaussian(8)"]
                          + online["forward_launches"] + resident["forward_launches"] + dp["launches"][0]
                          + sum(f for f, _ in dp["b_launches"]) + sum(sum(r["launches"]) for r in dp["sweeps"].values())
                          + measure["launches"] + scripts["launches"]["forward"] + trained["launches"])
    kernel_bwd["launches"] = (train["backward_launches"] + online["backward_launches"] + resident["backward_launches"]
                              + dp["launches"][1] + sum(b for _, b in dp["b_launches"])
                              + scripts["launches"]["backward"])

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [kernel, kernel_bwd]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
