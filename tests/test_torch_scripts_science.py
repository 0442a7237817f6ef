"""The port's science scripts (``scripts/{rho_trace,cross_estimator,
population_sweep}_torch.py``) against the JAX scripts beside them on the
CPU: each JAX ``main`` runs on a tree of the port's simulator at a 16-sample
pupil, its checkpoint lookup and ``build_model`` patched to flax variables of
narrow widths (features (4, 8, 16, 32)) that ``utils/convert_flax.py``
carries into the port's checkpoints."""

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu import models as jmodels
from galaxy_deconv_tpu.data import simulate as jsim
from galaxy_deconv_tpu.train import checkpoint as jcheckpoint
from galaxy_deconv_tpu_torch.data import generate_dataset
from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian, registry
from galaxy_deconv_tpu_torch.train import create_train_state
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.utils import model_state_dict
from torch_scripts_common import NARROW, TINY, flax_variables, load, one_thread, teardown_module  # noqa: F401

T0 = time.perf_counter()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_dataset(tmp_path_factory.mktemp("science") / "data", n_train=4, n_test=16,
                            cfg=sim.SimulationConfig(**TINY), chunk=16, snrs=(20, 100), shear_errs=(), fwhm_errs=(),
                            verbose=False, device="cpu")


def test_rho_trace_matches_jax(tree, tmp_path, monkeypatch):
    """Two variants (ADMM(4) and the bounded ADMM(2)) through both
    scripts on the same 4 galaxies and weights: every statistic of the
    report within REL of its largest JAX value (the schedule's quantiles and
    the iterate's progress; reads 2.3e-7 at most)."""
    REL = 1e-5
    rt = load("rho_trace_torch")
    monkeypatch.setattr(rt, "FEATURES", NARROW)
    runs = {"Gaussian_PnP_ADMM_4iters_MultiScale": "Unrolled_ADMM_Gaussian(4)",
            "Gaussian_PnP_ADMM_2iters_Bounded_MultiScale": "Unrolled_ADMM_Gaussian_Bounded(2)"}
    obs, psf = np.load(tree / "test" / "obs.npy")[:1], np.load(tree / "test" / "psf.npy")[:1]
    jax_models, variables = {}, {}
    for k, (run, build) in enumerate(runs.items()):
        jm = jmodels.build_model(build, analysis=True, features=NARROW)
        v = flax_variables(jm, (obs, psf, obs.mean(axis=(1, 2))), seed=k)
        jax_models[build], variables[run] = jm, {"params": v["params"], "batch_stats": v["batch_stats"]}
        state, _ = create_train_state(rt.build_model(build, analysis=True, features=NARROW), 0)
        state.model.load_state_dict(model_state_dict(v["params"], v["batch_stats"]))
        save_checkpoint(tmp_path / "port_models", run, 1, state)

    class Jitted:
        def __init__(self, model):
            self.apply = jax.jit(model.apply)

    monkeypatch.setattr(jmodels, "build_model", lambda name, **kw: Jitted(jax_models[name]))
    monkeypatch.setattr(jcheckpoint, "best_epoch", lambda src, name: int(src == "saved_models_online" and name in runs))
    monkeypatch.setattr(jcheckpoint, "restore_checkpoint", lambda src, name, ep: variables[name])
    monkeypatch.setattr(jcheckpoint, "unpack_variables", lambda st: st)
    monkeypatch.setattr(sys, "argv", ["rho_trace.py", "--data", str(tree), "--batch", "4", "--out",
                                      str(tmp_path / "jax"), "--cpu"])
    load("rho_trace").main()
    want = json.loads((tmp_path / "jax" / "rho_schedule.json").read_text())["models"]

    got = rt.trace_report(tree, 4, tmp_path / "none", tmp_path / "port_models", "cpu")["models"]
    assert set(got) == set(want) == {"Unrolled_ADMM_Gaussian(4)", "Unrolled_ADMM_Gaussian(2)_bounded"}
    for label, stats in want.items():
        for key, w in stats.items():
            if key == "ckpt":
                continue
            w, g = np.asarray(w, np.float64), np.asarray(got[label][key], np.float64)
            assert np.abs(g - w).max() <= REL * np.abs(w).max(), (label, key, np.abs(g - w).max() / np.abs(w).max())


def test_cross_estimator_matches_jax(tree, tmp_path, monkeypatch):
    """Both scripts on the same 16 stamps at SNR 20 and 100: every statistic
    (correlations, medians, the benchmark statistic under each estimator,
    the finite counts) within TOL * (1 + |JAX|); reads 1.5e-6 at most."""
    TOL = 1e-5
    monkeypatch.setattr(sys, "argv", ["cross_estimator.py", "--n_gal", "16", "--data", str(tree), "--snrs", "20",
                                      "100", "--out", str(tmp_path / "jax.json")])
    load("cross_estimator").main()
    assert load("cross_estimator_torch").main(["--n_gal", "16", "--data", str(tree), "--snrs", "20", "100", "--out",
                                               str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    want, got = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert got["n_gal"] == want["n_gal"] and set(got["snrs"]) == set(want["snrs"]) == {"20", "100"}
    for snr, row in want["snrs"].items():
        assert set(got["snrs"][snr]) == set(row)
        for key, w in row.items():
            pairs = w.items() if isinstance(w, dict) else [(None, w)]
            for sub, x in pairs:
                y = got["snrs"][snr][key] if sub is None else got["snrs"][snr][key][sub]
                assert abs(y - x) <= TOL * (1 + abs(x)), (snr, key, sub, y, x)


@pytest.mark.parametrize("attr", ["CONFIGS", "REF"])
def test_population_tables_equal_jax(attr):
    assert getattr(load("population_sweep_torch"), attr) == getattr(load("population_sweep"), attr)


def test_population_sweep_runs_with_the_flagship(tmp_path, monkeypatch, capsys):
    """Every population of the JAX script builds a ``SimulationConfig``.
    Both scripts' ``main`` on two populations (default, clumpy) at SNR 20 and
    40, 8 galaxies in chunks of 4 at a 16-sample pupil, each finding a
    flagship of the same narrow weights (carried by ``utils/convert_flax.py``):
    JAX's renders are the port's stamps for the same chunk seed, SNR and
    population, so both measure the same galaxies.  Every row (each method's
    median of min(|g_rec - g_gt|, 1) on the third shear column) and each
    fingerprint distance within a limit times (1 + |JAX|): TOL for the
    classical methods (reads 9.7e-7 at most) and the distance (2.6e-6),
    FLAGSHIP_TOL for the flagship (9.1e-6: eight unrolled iterations of two
    frameworks' float32 convolutions at random weights, then a shear
    estimate of what they return); the printed tables' header and reference
    rows are equal."""
    TOL, FLAGSHIP_TOL = 1e-5, 1e-4
    ps = load("population_sweep_torch")
    for overrides in ps.CONFIGS.values():
        sim.SimulationConfig(**overrides)
    build = jmodels.build_model
    jm = build("Unrolled_ADMM_Gaussian(8)", features=NARROW)
    z = np.zeros((1, 48, 48), np.float32)
    v = flax_variables(jm, (z, z, np.ones(1, np.float32)), seed=5)
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    state, _ = create_train_state(UnrolledADMMGaussian(n_iters=8, features=NARROW), 0)
    state.model.load_state_dict(model_state_dict(v["params"], v["batch_stats"]))
    save_checkpoint(tmp_path / "trained", ps.FLAGSHIP_RUN, 1, state)

    def port_stamps(key, n, snr, cfg):
        """The port's chunk for JAX's ``PRNGKey(seed)``: the same seed, SNR and population."""
        b = sim.simulate_batch_at_snr(int(np.asarray(key)[1]), n, snr, cfg, "cpu")
        return {k: jnp.asarray(b[k].numpy()) for k in ("obs", "psf", "gt")}

    monkeypatch.setenv("GDT_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(jsim, "SimulationConfig", lambda **kw: sim.SimulationConfig(**TINY, **kw))
    monkeypatch.setattr(jsim, "simulate_batch_at_snr", port_stamps)
    monkeypatch.setattr(jmodels, "build_model",
                        lambda name, **kw: jm if name == "Unrolled_ADMM_Gaussian(8)" else build(name, **kw))
    monkeypatch.setattr(jcheckpoint, "best_epoch", lambda src, name: int(name == ps.FLAGSHIP_RUN))
    monkeypatch.setattr(jcheckpoint, "restore_checkpoint", lambda src, name, ep: variables)
    monkeypatch.setattr(jcheckpoint, "unpack_variables", lambda st: st)
    args = ["--n_gal", "8", "--chunk", "4", "--configs", "default", "clumpy"]
    monkeypatch.setattr(sys, "argv", ["population_sweep.py", *args, "--out", str(tmp_path / "jax.json"), "--cpu"])
    load("population_sweep").main()
    jax_out = capsys.readouterr().out

    monkeypatch.setattr(ps, "SimulationConfig", functools.partial(sim.SimulationConfig, **TINY))
    monkeypatch.setitem(registry.MODEL_REGISTRY, "Unrolled_ADMM_Gaussian",
                        functools.partial(UnrolledADMMGaussian, features=NARROW))
    assert ps.main([*args, "--trained", str(tmp_path / "trained"), "--out", str(tmp_path / "port.json"), "--device",
                    "cpu"]) == 0
    port_out = capsys.readouterr().out
    want, got = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "port.json"))
    assert got["n_gal"] == want["n_gal"] == 8 and got["reference"] == want["reference"]
    assert list(got["configs"]) == list(want["configs"]) == ["default", "clumpy"]
    methods = {"No_Deconv", "FPFS", "Richard-Lucy(30)", "Unrolled_ADMM_Gaussian(8)"}
    for name, rows in want["configs"].items():
        assert set(got["configs"][name]) == set(rows) == {"20", "40", "fingerprint_dist"}
        for key, w in rows.items():
            g = got["configs"][name][key]
            pairs = [(None, w, g)] if key == "fingerprint_dist" else [(m, w[m], g[m]) for m in w]
            if key != "fingerprint_dist":
                assert set(g) == set(w) == methods, (name, key)
            for m, x, y in pairs:
                limit = FLAGSHIP_TOL if m == "Unrolled_ADMM_Gaussian(8)" else TOL
                assert abs(y - x) <= limit * (1 + abs(x)), (name, key, m, y, x)
    for prefix in ("| config |", "| **reference** |"):
        assert [ln for ln in port_out.splitlines() if ln.startswith(prefix)] == \
               [ln for ln in jax_out.splitlines() if ln.startswith(prefix)] != []
