"""The port's measurement scripts (``scripts/{reconcile_throughput,profile_ops,
scaling}_torch.py``) on the CPU at narrow widths: ``profile_ops``' FFT path
against the JAX package's spectra, Wiener init, x-update and dual loop, the
reports' schemas against the JAX scripts', the checkpoint lookup, and
``scaling``'s world sizes.  The times they print here are the CPU's and
mean nothing for the card."""

import ast
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.models import unrolled_admm_gaussian as J
from galaxy_deconv_tpu_torch import bench
from galaxy_deconv_tpu_torch.data import generate_dataset
from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.train import create_train_state
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from torch_scripts_common import NARROW, REPO, TINY, load, one_thread, teardown_module  # noqa: F401

FLAGSHIP_RUN = "Gaussian_PnP_ADMM_8iters_MultiScale"
T0 = time.perf_counter()


def jax_fftpath(y, p, a, impl):
    """``scripts/profile_ops.py``'s FFT path (its ``make_fftpath``, :104-119)."""
    y = jnp.maximum(y, 0.0)
    shape = (48, 48)
    Y, Ht, HtH = J.gaussian_spectra(y, p, impl)
    z = J.wiener_init(Y, Ht, HtH, a, shape, impl)
    u = jnp.zeros_like(y)
    for _ in range(8):
        rho = jnp.full((y.shape[0], 1, 1), 0.5, jnp.float32)
        x = J.x_update(Y, Ht, HtH, z, u, rho, shape, impl)
        z = x
        u = u + rho * (x - z)
    return z


@pytest.mark.parametrize("impl,jax_impl", [("fft", "xla"), ("matmul", "matmul")])
def test_fftpath_matches_jax(impl, jax_impl):
    """The identity-denoiser path on ``bench.py``'s stamps, both spectral
    transforms: within REL of the largest JAX value (float32 FFTs of two
    libraries, 8 x-updates; reads 1.4e-6 with torch.fft, 2.0e-6 with the DFT
    matmuls)."""
    REL = 1e-5
    obs, psf, alpha = bench.bench_inputs(4)
    got = load("profile_ops_torch").fftpath(*map(torch.from_numpy, (obs, psf, alpha)), impl).numpy()
    want = np.asarray(jax_fftpath(jnp.asarray(obs), jnp.asarray(psf), jnp.asarray(alpha), jax_impl))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= REL, rel


# scripts/profile_ops.py:75-76 and :178-180: its report's keys and component names
JAX_PROFILE_KEYS = {"batch", "repeats", "dtype", "device", "timings_ms", "gal_per_sec", "dispatch_overhead_ms"}
JAX_COMPONENTS = ["full", "model", "shear", "denoiser8", "denoiser1", "fftpath_xla", "fftpath_dft", "conv_48x48x32",
                  "conv_24x24x64", "conv_12x12x128", "conv_6x6x256", "loop8"]


def test_profile_ops_report_and_full_rows(tmp_path, monkeypatch):
    """``main`` at B = 2: the JAX report's keys and components (the FFT paths
    named by the port's transforms), and its ``full`` component equal to the
    bench pipeline's rows."""
    po = load("profile_ops_torch")
    monkeypatch.setattr(po, "FEATURES", NARROW)
    monkeypatch.setattr(po, "STAGES", ((48, 4), (24, 8), (12, 16), (6, 32)))
    assert po.main(["--batch", "2", "--repeats", "1", "--dtype", "float32", "--out", str(tmp_path / "p.json"),
                    "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "p.json").read_text())
    assert JAX_PROFILE_KEYS <= set(report) and report["card"] is None and report["clock"] == "host"
    names = [{"fftpath_xla": "fftpath_fft", "fftpath_dft": "fftpath_matmul"}.get(n, n) for n in JAX_COMPONENTS]
    assert [n for n in report["timings_ms"] if not n.startswith("conv_")] == [n for n in names
                                                                              if not n.startswith("conv_")]
    assert sum(n.startswith("conv_") for n in report["timings_ms"]) == 4
    assert all(v["ms_per_call"] > 0 for v in report["timings_ms"].values())
    pipe = bench.bench_pipeline("float32", "cpu", features=NARROW)
    inputs = [torch.as_tensor(a) for a in bench.bench_inputs(2)]
    comps = po.components(pipe, *inputs, torch.float32)
    assert torch.equal(comps["full"][0](), pipe(*inputs))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("measure")
    generate_dataset(root / "data", n_train=4, n_test=16, cfg=sim.SimulationConfig(**TINY),
                     chunk=16, snrs=(20,), shear_errs=(), fwhm_errs=(), verbose=False, device="cpu")
    state, _ = create_train_state(UnrolledADMMGaussian(n_iters=8, features=NARROW), 0)
    save_checkpoint(root / "trained", FLAGSHIP_RUN, 3, state)
    return root


# scripts/reconcile_throughput.py:81-100 and :104: its configurations, their rows' keys, the report's keys
JAX_CONFIGS = ["A_eval_harness_fp32_b250", "B_plus_batch256", "C_plus_bf16", "D_device_resident_bf16_b256"]
JAX_ROW_KEYS = {"batch", "dtype", "input", "gal_per_sec"}


def test_reconcile_report_and_lookup(tree, tmp_path, monkeypatch):
    """``main`` at batches of 4 and 8: the JAX report's keys, the checkpoint
    found in ``--trained`` when ``--ckpt`` has none; A's and B's shears of
    the same galaxies within SHEAR_TOL * (1 + |g|) (the convolutions at two
    batch sizes; reads 0 on one thread, 2.7e-6 on eight)."""
    SHEAR_TOL = 1e-4
    rt = load("reconcile_throughput_torch")
    monkeypatch.setattr(rt, "FEATURES", NARROW)
    monkeypatch.setattr(rt, "HARNESS_CONFIGS", {k: (b, dt) for (k, (_, dt)), b in
                                                zip(rt.HARNESS_CONFIGS.items(), (4, 8, 8))})
    monkeypatch.setattr(rt, "RESIDENT_BATCH", 8)
    out = tmp_path / "r.json"
    assert rt.main(["--data", str(tree / "data"), "--n_gal", "8", "--ckpt", str(tmp_path / "none"), "--trained",
                    str(tree / "trained"), "--out", str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert list(report["configs"]) == JAX_CONFIGS and all(set(r) == JAX_ROW_KEYS for r in report["configs"].values())
    assert {"ckpt", "n_gal", "configs"} <= set(report) and report["ckpt"].endswith(f"trained/{FLAGSHIP_RUN}_3epochs")
    state, _ = create_train_state(UnrolledADMMGaussian(n_iters=8, features=NARROW), 1)
    save_checkpoint(tmp_path / "scratch", FLAGSHIP_RUN, 5, state)  # --ckpt comes first
    assert rt.find_checkpoint(FLAGSHIP_RUN, tmp_path / "scratch", tree / "trained") == (tmp_path / "scratch", 5)
    _, shears = rt.reconcile(state.model.state_dict(), tree / "data", 8, "cpu")
    a, b = shears["A_eval_harness_fp32_b250"], shears["B_plus_batch256"]
    assert a.shape == b.shape == (8, 3)
    err = (np.abs(a - b) / (1 + np.abs(b))).max()
    assert err <= SHEAR_TOL, err


def jax_world_sizes():
    """``scripts/scaling.py``'s own ``sizes = ...`` expression in its
    ``main``, compiled from its source, as a function of ``n_total``."""
    main = next(n for n in ast.parse((REPO / "scripts" / "scaling.py").read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and [getattr(t, "id", None) for t in n.targets] == ["sizes"])
    code = compile(ast.Expression(node.value), "scripts/scaling.py", "eval")
    return lambda n_total: eval(code, {}, {"n_total": n_total})


def test_scaling_world_sizes_and_run(monkeypatch, capsys):
    """The world sizes of ``scripts/scaling.py``'s ``main`` at every world up
    to 16, and one process on the CPU (no launcher, no process group)."""
    sc, want = load("scaling_torch"), jax_world_sizes()
    for n in range(1, 17):
        assert sc.world_sizes(n) == want(n)
    monkeypatch.setattr(sc, "FEATURES", NARROW)
    assert sc.main(["--steps", "1", "--n_iters", "1", "--per_device_batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "1 process(es) (no process group)" in out and "1 device(s): " in out and "gal/s train" in out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.main(["--steps", "1"])
