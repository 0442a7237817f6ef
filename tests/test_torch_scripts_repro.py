"""The port's reproduction scripts (``scripts/{train_zoo,export_trained,
reference_protocol,generate_sharded,run_benchmark,make_figures}_torch.py``)
against the JAX scripts beside them, on the CPU at narrow widths and a
16-sample pupil, and ``scripts/extract_loss.py`` on the port's training
outputs.  The JAX scripts are loaded from their files; their heavy imports
sit inside ``main()``, which runs here only where it neither trains nor
simulates at the default optics."""

import csv
import functools
import io
import json
import logging
import shutil
import sys
import time

import jax
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu import analysis as janalysis
from galaxy_deconv_tpu import models as jmodels
from galaxy_deconv_tpu.train import checkpoint as jcheckpoint
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.data import generate_dataset
from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian, registry
from galaxy_deconv_tpu_torch.train import online
from galaxy_deconv_tpu_torch.train.checkpoint import STATE_FILE, best_epoch
from galaxy_deconv_tpu_torch.utils import model_state_dict
from torch_scripts_common import NARROW, REPO, TINY, flax_variables, load, one_thread, teardown_module  # noqa: F401

T0 = time.perf_counter()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A benchmark tree of the port's simulator at a 16-sample pupil."""
    return generate_dataset(tmp_path_factory.mktemp("repro") / "data", n_train=8, n_test=16,
                            cfg=sim.SimulationConfig(**TINY), chunk=16, shear_errs=(0.01,), fwhm_errs=(0.01,),
                            verbose=False, device="cpu")


@pytest.mark.parametrize("script,attr", [("train_zoo", "SPECS"), ("run_benchmark", "TRAINED_SPECS"),
                                         ("run_benchmark", "REF_TRANSPLANTS"), ("generate_sharded", "SNRS"),
                                         ("generate_sharded", "ERRS")])
def test_spec_tables_equal_jax(script, attr):
    assert getattr(load(f"{script}_torch"), attr) == getattr(load(script), attr)


def _block(text: str, tag: str) -> str:
    return text.split(f"<!-- {tag} START -->", 1)[1].split(f"<!-- {tag} END -->", 1)[0]


def test_summarize_only_writes_jax_blocks(tmp_path, monkeypatch):
    """``--summarize_only`` of both scripts over a copy of three committed
    method directories (each shear list cut to its first 500 galaxies, for
    the bootstrap's time): every table block identical.  JAX's writes
    RESULTS.md in the working directory (given every block's markers, as the
    port's new file has), the port's into ``<result>/RESULTS.md``."""
    port = load("run_benchmark_torch")
    res = tmp_path / "results"
    for m in ("No_Deconv", "FPFS", "Richard-Lucy(30)"):
        shutil.copytree(REPO / "results_tpu" / m, res / m)
        for f in (res / m).glob("results*.json"):
            r = json.loads(f.read_text())
            for entry in r.values():
                for k in ("rec_shear", "gt_shear"):
                    if isinstance(entry, dict) and k in entry:
                        entry[k] = entry[k][:500]
            f.write_text(json.dumps(r))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GDT_NO_COMPILE_CACHE", "1")
    (tmp_path / "RESULTS.md").write_text(port.results_skeleton(1000))
    monkeypatch.setattr(sys, "argv", ["run_benchmark.py", "--summarize_only", "--result", str(res), "--ckpt",
                                      str(tmp_path / "none"), "--cpu"])
    load("run_benchmark").main()
    assert port.main(["--summarize_only", "--result", str(res), "--ckpt", str(tmp_path / "none"), "--trained",
                      str(tmp_path / "none"), "--device", "cpu"]) == 0
    want, got = (tmp_path / "RESULTS.md").read_text(), (res / "RESULTS.md").read_text()
    for tag in port.BLOCKS:
        assert _block(got, tag) == _block(want, tag), tag
    assert "| Richard-Lucy(30) |" in _block(got, "BENCHMARK TABLE")


def test_generate_sharded_merge_is_generate_dataset_byte_for_byte(tmp_path, monkeypatch):
    """Two workers and the merge give ``generate_dataset``'s files, byte for
    byte, with every perturbed-PSF set, at a ragged last chunk."""
    gs = load("generate_sharded_torch")
    monkeypatch.setattr(gs, "SimulationConfig", functools.partial(sim.SimulationConfig, **TINY))
    common = ["--root", str(tmp_path / "sharded"), "--n_train", "6", "--n_test", "10", "--chunk", "4",
              "--device", "cpu"]
    for shard in (0, 1):
        gs.main(["worker", "--shard", str(shard), "--n_shards", "2", *common])
    with pytest.raises(SystemExit):  # a missing chunk stops the merge
        gs.run_merge(tmp_path / "sharded", gs.chunk_plan(31415, 6, 14, 4), {})
    gs.main(["merge", *common])
    ref = generate_dataset(tmp_path / "direct", n_train=6, n_test=10, cfg=sim.SimulationConfig(**TINY), chunk=4,
                           seed=31415, verbose=False, device="cpu")
    files = sorted(str(f.relative_to(ref)) for f in ref.rglob("*") if f.is_file())
    made = sorted(str(f.relative_to(tmp_path / "sharded")) for f in (tmp_path / "sharded").rglob("*")
                  if f.is_file() and "_shards" not in f.parts)
    assert made == files and len(files) == 7 + 7 + 2 * 7 + 2 * 10 + 1  # train, test, SNR variants, PSF sets, info
    assert all((ref / f).read_bytes() == (tmp_path / "sharded" / f).read_bytes() for f in files)


def test_reference_protocol_save_rule_matches_reference():
    """The save rule against the reference's (train.py:137-143, as the JAX
    script runs it): after 0-based epoch e, save when the validation loss
    beats the best so far or (e + 1) % 5 == 0, then record a new best."""
    rp = load("reference_protocol_torch")
    vals = [5.0, 4.0, 4.5, 4.2, 4.6, 3.0, 3.5, 3.9, 3.1, 2.9, 3.0, float("nan"), 2.95, 2.0, 2.5]
    saved, best, best_ep = [], float("inf"), 0
    for e, val in enumerate(vals):
        if val < best or (e + 1) % 5 == 0:
            if val < best:
                best, best_ep = val, e + 1
            saved.append(e + 1)
    assert rp.saved_epochs(vals) == (saved, best_ep) == ([1, 2, 5, 6, 10, 14, 15], 14)
    assert [e for e, v in enumerate(vals, 1) if rp.should_save(e, v, 0.0)] == [5, 10, 15]


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """``train_zoo_torch --models admm2 --steps 2`` on the CPU at narrow widths
    and a 16-sample pupil, validation every 2 steps over 1 batch."""
    tz = load("train_zoo_torch")
    save = tmp_path_factory.mktemp("zoo") / "models"
    patches = {"FEATURES": NARROW, "VAL_EVERY": 2,
               "SimulationConfig": functools.partial(sim.SimulationConfig, **TINY),
               "fit_online": functools.partial(online.fit_online, val_batches=1)}
    saved = {k: getattr(tz, k) for k in patches}
    for k, v in patches.items():
        setattr(tz, k, v)
    try:
        assert tz.main(["--models", "admm2", "--steps", "2", "--steps_per_call", "2", "--batch", "2", "--save_path",
                        str(save), "--device", "cpu"]) == 0
    finally:
        for k, v in saved.items():
            setattr(tz, k, v)
    return save, tz.SPECS["admm2"][0]


def test_train_zoo_history_gives_jax_best_epoch(zoo):
    save, name = zoo
    hist = json.loads((save / f"{name}_history.json").read_text())
    assert hist["step"] == [2] and hist["best_step"] == 2 and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    assert jcheckpoint.best_epoch(save, name) == best_epoch(save, name) == 2
    assert jcheckpoint.latest_epoch(save, name) == 2


def test_export_trained_loads_in_cli_test(zoo, tree, tmp_path, monkeypatch):
    """The exported checkpoint holds the weights and no optimizer state, in
    ``trained_to_port.py``'s layout, and ``cli test`` loads it."""
    save, name = zoo
    assert load("export_trained_torch").main(["--src", str(save), "--dst", str(tmp_path / "exp")]) == 0
    payload = torch.load(tmp_path / "exp" / f"{name}_2epochs" / STATE_FILE, weights_only=True)
    trained = torch.load(save / f"{name}_2epochs" / STATE_FILE, weights_only=True)
    assert payload["opt_state"] == {"count": 0, "mu": {}, "nu": {}} and payload["step"] == 2
    assert payload["model"].keys() == trained["model"].keys()
    assert all(torch.equal(payload["model"][k], v) for k, v in trained["model"].items())
    monkeypatch.setitem(registry.MODEL_REGISTRY, "Unrolled_ADMM_Gaussian",
                        functools.partial(UnrolledADMMGaussian, features=NARROW))
    out = cli.main(["test", "--data_path", str(tree), "--result_path", str(tmp_path / "res"), "--n_gal", "4",
                    "--eval_batch_size", "4", "--snrs", "20", "--methods", "Unrolled_ADMM_Gaussian(2)",
                    "--model_save_path", str(tmp_path / "exp"), "--checkpoint_name", name, "--device", "cpu"])
    assert np.isfinite(out["Unrolled_ADMM_Gaussian(2)"]["20"]["rec_shear"]).all()


def test_train_zoo_init_from_warm_starts_the_first_model(zoo, tmp_path, monkeypatch):
    """``--init_from`` an exported run, as a continuation is started: the
    first model of ``--models`` enters ``fit_online`` under its suffixed
    name with the exported weights and BatchNorm statistics, every tensor
    equal, in the model its train state steps; the second model keeps its
    seed-0 weights."""
    save, name = zoo
    assert load("export_trained_torch").main(["--src", str(save), "--dst", str(tmp_path / "exp")]) == 0
    exported = torch.load(tmp_path / "exp" / f"{name}_2epochs" / STATE_FILE, weights_only=True)["model"]
    tz = load("train_zoo_torch")
    seen = {}

    def fit_online(model, state, optimizer, loss, **kw):
        assert state.model is model
        seen[kw["model_name"]] = {k: v.clone() for k, v in model.state_dict().items()}
        return state, {"val_loss": [], "galaxies_per_sec": 0.0}

    monkeypatch.setattr(tz, "FEATURES", NARROW)
    monkeypatch.setattr(tz, "SimulationConfig", functools.partial(sim.SimulationConfig, **TINY))
    monkeypatch.setattr(tz, "fit_online", fit_online)
    assert tz.main(["--models", "admm2", "admm2_bounded", "--steps", "2", "--init_from",
                    str(tmp_path / "exp" / f"{name}_2epochs"), "--suffix", "_cont", "--device", "cpu"]) == 0
    bounded = tz.SPECS["admm2_bounded"][0] + "_cont"
    assert list(seen) == [name + "_cont", bounded]
    warm = seen[name + "_cont"]
    assert warm.keys() == exported.keys() and all(torch.equal(warm[k], v) for k, v in exported.items())
    assert not all(torch.equal(seen[bounded][k], v) for k, v in exported.items())


def test_make_figures_trace_arrays_match_jax(tree, tmp_path, monkeypatch):
    """``make_figures_torch.model_arrays`` against the JAX script's gallery and
    trace inputs (its plots captured) on the same stamps and weights, the
    weights carried by ``utils/convert_flax.py`` at features (4, 8, 16, 32):
    each trace within TRACE_REL of its largest value (8 unrolled iterations
    of two frameworks' float32 convolutions and FFTs, on one thread: x
    4.5e-6, z 5.7e-6, u 7.4e-6, rho 1.5e-7; on eight, u 7.8e-6)."""
    TRACE_REL = 1e-5
    mf = load("make_figures_torch")
    monkeypatch.setattr(mf, "FEATURES", NARROW)
    jm = jmodels.build_model("Unrolled_ADMM_Gaussian(8)", analysis=True, features=NARROW)
    obs = np.load(tree / "test" / "obs_100.npy")[:6]
    psf = np.load(tree / "test" / "psf.npy")[:6]
    v = flax_variables(jm, (obs[:1], psf[:1], obs[:1].mean(axis=(1, 2))), seed=3)
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}

    class Jitted:
        def __init__(self, model):
            self.apply = jax.jit(model.apply)

    captured = {}
    monkeypatch.setattr(jmodels, "build_model", lambda name, **kw: Jitted(jm))
    monkeypatch.setattr(jcheckpoint, "latest_epoch", lambda *a: 1)
    monkeypatch.setattr(jcheckpoint, "restore_checkpoint", lambda *a: variables)
    monkeypatch.setattr(jcheckpoint, "unpack_variables", lambda st: st)
    for fn in ("plot_error_vs_snr", "plot_error_vs_time", "plot_psf_error"):
        monkeypatch.setattr(janalysis, fn, lambda *a, **k: None)
    monkeypatch.setattr(janalysis, "plot_reconstruction_grid", lambda panels, **k: captured.update(panels=panels))
    monkeypatch.setattr(janalysis, "plot_admm_trace", lambda traces, **k: captured.update(traces=traces))
    (tmp_path / "res").mkdir()
    monkeypatch.setattr(sys, "argv", ["make_figures.py", "--result", str(tmp_path / "res"), "--out",
                                      str(tmp_path / "fig"), "--data", str(tree), "--ckpt", str(tmp_path), "--cpu"])
    load("make_figures").main()

    got = mf.model_arrays(model_state_dict(v["params"], v["batch_stats"]), tree, 100, "cpu")
    for k in ("x", "z", "u", "rho"):
        want = np.asarray(captured["traces"][k])
        rel = np.abs(got["traces"][k] - want).max() / np.abs(want).max()
        assert rel <= TRACE_REL, (k, rel)
    np.testing.assert_array_equal(got["obs"], captured["panels"]["observed"])
    np.testing.assert_array_equal(got["gt"], captured["panels"]["ground truth"])


def test_extract_loss_reads_the_port_history_and_log(tmp_path, caplog):
    """``scripts/extract_loss.py`` on the port's ``fit_online`` outputs: its
    CSV from the history file and from the captured log give the same steps
    and losses (the log prints 5 significant digits: rel 5e-5)."""
    model = UnrolledADMMGaussian(n_iters=1, features=(4, 4, 4, 4))
    from galaxy_deconv_tpu_torch.losses import MultiScaleLoss
    from galaxy_deconv_tpu_torch.train import create_train_state

    state, opt = create_train_state(model, 0)
    with caplog.at_level(logging.INFO, logger=online.logger.name):
        _, hist = online.fit_online(model, state, opt, MultiScaleLoss(), n_steps=4, batch_size=2,
                                    sim_cfg=sim.SimulationConfig(**TINY), log_every=2, val_every=2, val_batches=1,
                                    model_name="m", save_path=str(tmp_path))
    log = tmp_path / "train.log"
    log.write_text("\n".join(r.getMessage() for r in caplog.records))
    ex = load("extract_loss")
    rows = {}
    for source in (tmp_path / "m_history.json", log):
        out = tmp_path / f"{source.stem}.csv"
        sys_argv = sys.argv
        try:
            sys.argv = ["extract_loss.py", str(source), "--out", str(out)]
            ex.main()
        finally:
            sys.argv = sys_argv
        rows[source.suffix] = list(csv.DictReader(io.StringIO(out.read_text())))
    assert [r["step"] for r in rows[".json"]] == [r["step"] for r in rows[".log"]] == ["2", "4"]
    for a, b in zip(rows[".json"], rows[".log"]):
        for k in ("train_loss", "val_loss"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=5e-5)
    assert [float(r["val_loss"]) for r in rows[".json"]] == hist["val_loss"]
