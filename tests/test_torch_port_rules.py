"""Rules of the PyTorch port: it runs where JAX does not exist.

Every module of galaxy_deconv_tpu_torch, chip_smoke.py and the port's
scripts and tutorials (``scripts/*_torch.py`` but the bf16 cross-check,
``examples/*_torch.py``) import with jax, flax, orbax and the JAX package
blocked, and chip_smoke.py's pipeline,
training (through ``cli train``), generate, test, zoo, trainers,
data-parallel, measurement, scripts and trained-flagship phases and the package's ``python -m`` entry point
(``generate`` then ``test``) run on the CPU (at a tiny size, through the plain
x-update solve and its plain backward) with them blocked, the data-parallel
phase's ranks too.  chip_smoke.py exits non-zero and prints no
result without a card, and when it stands alone in a directory."""

import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
PORT = REPO / "galaxy_deconv_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "galaxy_deconv_tpu")
# the port's scripts and tutorials; scripts/bf16_parity_torch.py is a cross-check that reads the JAX package's
# orbax checkpoint and runs both packages, so it imports JAX as the tests do
ENTRY_SCRIPTS = sorted(p for p in [*REPO.glob("scripts/*_torch.py"), *REPO.glob("examples/*_torch.py")]
                       if p.name != "bf16_parity_torch.py")

_BLOCKER = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
"""


def run_blocked(body: str, timeout: int = 300, env: dict = ENV) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _BLOCKER + body], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


def port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_module_and_chip_smoke_import_without_jax():
    body = f"""
import importlib, importlib.util
for name in {port_modules()!r}:
    importlib.import_module(name)
for path in [{str(REPO / "chip_smoke.py")!r}, *{[str(p) for p in ENTRY_SCRIPTS]!r}]:
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1].removesuffix(".py"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len({port_modules()!r}))
"""
    res = run_blocked(body)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(port_modules())}" in res.stdout


def test_blocker_blocks():
    res = run_blocked("import galaxy_deconv_tpu.ops.fourier")
    assert res.returncode != 0 and "blocked import" in res.stderr


@pytest.mark.parametrize("path", [REPO / "chip_smoke.py", *ENTRY_SCRIPTS, *sorted(PORT.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path.name}:{node.lineno} imports {name}"


def test_chip_smoke_pipeline_phases_run_on_cpu_without_jax():
    body = """
import importlib.util, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
cpu = torch.device("cpu")
fp32 = cs.phase_pipeline_fp32(cpu, B=4, n_iters=2, features=(8, 8, 8, 8), n_check=2)
bf16 = cs.phase_pipeline_bf16(cpu, fp32, B=4, n_iters=2, features=(8, 8, 8, 8))
assert fp32["rec"].shape == (4, 48, 48) and bf16["shear"].shape == (4, 3)
assert fp32["launches"] == bf16["launches"] == 0  # CPU tensors take the plain solve
print("phases ok")
"""
    res = run_blocked(body)
    assert res.returncode == 0, res.stderr
    assert "phases ok" in res.stdout


def test_chip_smoke_train_phase_runs_on_cpu_without_jax():
    body = """
import importlib.util, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
res = cs.phase_train_fp32(torch.device("cpu"), B=4, n_stamps=12, n_iters=1, features=(8, 8, 8, 8), n_check=2,
                          n_steps=4, n_warm=1)
assert res["forward_launches"] == res["backward_launches"] == 0  # CPU tensors take the plain versions
print("train phase ok")
"""
    res = run_blocked(body)
    assert res.returncode == 0, res.stderr
    assert "train phase ok" in res.stdout
    assert "checkpoint" in res.stdout and "bit-exact" in res.stdout


def test_chip_smoke_generate_and_test_phases_run_on_cpu_without_jax():
    body = """
import importlib.util, pathlib, tempfile, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
cpu = torch.device("cpu")
with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp) / "data"
    gen = cs.phase_generate(cpu, root, n_train=2, n_test=3, pupil_n=16, chunk=4, errs=(0.05,), n_check=2)
    res = cs.phase_test(cpu, root, pathlib.Path(tmp) / "results", "cpu",
                        methods=("No_Deconv", "FPFS", "Wiener", "Richard-Lucy(30)", "Unrolled_ADMM_Gaussian(1)"),
                        flagship="Unrolled_ADMM_Gaussian(1)", n_gal=3, batch=2, snrs=(20,), errs=(0.05,), n_check=2)
assert max(gen["rel"].values()) == 0 and gen["n_test"] == 3
assert set(res["launches"].values()) == {0}  # CPU tensors take the plain solve
print("eval phases ok")
"""
    res = run_blocked(body, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "eval phases ok" in res.stdout and "gal/s" in res.stdout


def test_chip_smoke_zoo_phase_runs_on_cpu_without_jax():
    """Phase 9 at a tiny size, which runs the zoo's commands (``generate
    --task Denoise``, ``train --model ResUNet|Tikhonet``, ``test`` with zoo
    names) in this JAX-blocked process: one model of each class, one-iteration
    solvers and narrow nets for the card-against-CPU check, 3 galaxies, 8
    training stamps (one step of each trainer)."""
    body = """
import importlib.util, pathlib, tempfile, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)  # the full-width models' CPU work, on a machine whose cores may be shared
cpu = torch.device("cpu")
narrow = {"features": (8, 8, 8, 8)}
methods = ("Unrolled_ADMM(1)", "ShapeNet", "ADMMNet_fixed(1)", "ResUNet")
with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp) / "data"
    cs.phase_generate(cpu, root, n_train=2, n_test=3, pupil_n=16, chunk=4, errs=(0.05,), n_check=2)
    res = cs.phase_zoo(cpu, root, pathlib.Path(tmp) / "zoo", "cpu", methods=methods, n_gal=3, batch=2, snrs=(20,),
                       n_check=2, n_denoise=8, train_batch=4,
                       model_kwargs={m: narrow for m in methods if m != "ShapeNet"})
assert set(res["rec_rel"]) == set(methods) and max(res["rec_rel"].values()) == 0
assert res["train"]["ResUNet"]["steps"] == res["train"]["Tikhonet"]["steps"] == 1
print("zoo phase ok")
"""
    res = run_blocked(body, timeout=600)
    assert res.returncode == 0, res.stderr
    # ShapeNet trains now (phase 10; test_chip_smoke_trainers_phase_runs_on_cpu_without_jax): no refusal to see
    assert "zoo phase ok" in res.stdout and "bit-exact" in res.stdout


def test_cli_generate_then_test_run_on_cpu_without_jax(tmp_path):
    body = f"""
import json, pathlib, runpy, sys
root, res = pathlib.Path({str(tmp_path / "data")!r}), pathlib.Path({str(tmp_path / "results")!r})

def run(*argv):
    sys.argv = ["galaxy_deconv_tpu_torch", *argv]
    runpy.run_module("galaxy_deconv_tpu_torch", run_name="__main__", alter_sys=True)

run("generate", "--data_path", str(root), "--n_train", "2", "--n_test", "3", "--pupil_n", "16", "--errs", "0.02",
    "--device", "cpu")
run("test", "--data_path", str(root), "--result_path", str(res), "--n_gal", "3", "--eval_batch_size", "2",
    "--snrs", "20", "--methods", "Wiener", "Unrolled_ADMM_Gaussian(1)", "--device", "cpu")
for m in ("Wiener", "Unrolled_ADMM_Gaussian(1)"):
    assert len(json.loads((res / m / "results.json").read_text())["20"]["rec_shear"]) == 3
print("cli ok")
"""
    res = run_blocked(body, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "cli ok" in res.stdout and "dataset written to" in res.stdout


def test_package_entry_point_runs_without_jax():
    body = """
import runpy, sys
sys.argv = ["galaxy_deconv_tpu_torch", "train", "--help"]
try:
    runpy.run_module("galaxy_deconv_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
"""
    res = run_blocked(body)
    assert res.returncode == 0, res.stderr
    assert "--data_path" in res.stdout and "--device" in res.stdout


def test_chip_smoke_main_fails_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.main() would run the full check")
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=ENV)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_trainers_phase_runs_on_cpu_without_jax():
    """Phase 10 at a tiny size in this JAX-blocked process: ``cli train
    --online`` (4 steps in calls of 2, a 16-sample pupil), the fused call, the
    online step against the CPU, an epoch of ``fit_device_resident`` and its
    checks, ``cli train --model ShapeNet`` and the three losses."""
    body = """
import importlib.util, pathlib, tempfile, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)
cpu = torch.device("cpu")
narrow = (8, 8, 8, 8)
with tempfile.TemporaryDirectory() as tmp:
    tmp = pathlib.Path(tmp)
    root = cs.write_dataset(tmp / "data", n=24)
    # a 1-iteration net of width 8 on 2 stamps of a 16-sample pupil holds its zero-gradient conv biases at 1e-3 to
    # 7e-3 of its largest gradient (rounding noise of its own step; the card's full-width flagship, 1e-6 to 2e-4)
    on = cs.phase_online(cpu, "cpu", tmp / "online", B=2, n_steps=4, k=2, val_every=2, val_batches=1, pupil_n=16,
                         n_iters=1, features=narrow, n_check=2, zero_tol=0.1)
    dr = cs.phase_device_resident(cpu, "cpu", root, B=4, n_iters=1, features=narrow, k=2)
    sh = cs.phase_shapenet_and_losses(cpu, "cpu", root, tmp / "shapenet", B=4)
assert on["hist"]["step"] == [2, 4] and on["forward_launches"] == on["backward_launches"] == 0
assert dr["forward_launches"] == 0 and set(sh["readings"]) == {"Shape", "BestEllipse", "MomentBasedLoss"}
print("trainers phase ok")
"""
    res = run_blocked(body, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "trainers phase ok" in res.stdout and "no host sync" in res.stdout


def test_chip_smoke_data_parallel_phase_runs_on_cpu_without_jax(tmp_path):
    """Phase 11 at a tiny size over gloo, in its two torchrun calls: (a) ``cli
    train`` at world size 1 against phase 6's epoch, (b) two ranks of 2
    against one process on 4, (c) ``cli test`` at world sizes 1 and 2 against
    phase 8's rows.  The ranks are other interpreters; a ``sitecustomize`` on
    their PYTHONPATH blocks JAX in them too."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    body = """
import importlib.util, pathlib, tempfile, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)
cpu = torch.device("cpu")
narrow = (8, 8, 8, 8)
with tempfile.TemporaryDirectory() as tmp:
    tmp = pathlib.Path(tmp)
    p6 = cs.phase_train_fp32(cpu, B=4, n_stamps=12, n_iters=1, features=narrow, n_check=2, n_steps=2, n_warm=1)
    cs.phase_generate(cpu, tmp / "gen", n_train=2, n_test=3, pupil_n=16, chunk=4, errs=(0.05,), n_check=2)
    cs.phase_test(cpu, tmp / "gen", tmp / "results", "cpu", methods=("No_Deconv", "Unrolled_ADMM_Gaussian(1)"),
                  flagship="Unrolled_ADMM_Gaussian(1)", n_gal=3, batch=2, snrs=(20,), errs=(0.05,), n_check=2)
    dp = cs.phase_data_parallel(cpu, "cpu", tmp / "gen", tmp / "results", tmp / "dp", p6, B=4, n_stamps=12,
                                n_iters=1, features=narrow, method="Unrolled_ADMM_Gaussian(1)", n_gal=3, batch=2,
                                snrs=(20,))
# CPU tensors take the plain versions
assert dp["launches"] == (0, 0) and dp["b_launches"] == [(0, 0), (0, 0)] and dp["sweeps"][2]["launches"] == [0, 0]
assert dp["sweeps"][1]["err"] == dp["sweeps"][2]["err"] == 0
print("data parallel phase ok")
"""
    res = run_blocked(body, timeout=600, env={**ENV, "PYTHONPATH": str(site)})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "data parallel phase ok" in res.stdout and "replicas bit-identical: True" in res.stdout


def test_chip_smoke_measurement_phase_runs_on_cpu_without_jax(tmp_path):
    """Phase 12 at a tiny size in this JAX-blocked process (``cli bench`` in
    subprocesses, blocked through a ``sitecustomize`` on their PYTHONPATH):
    ``cli bench`` at B = 2 in both dtypes, the bench module's timed run
    against phase 4's rows at the same width, the MFU report (counted on the
    CPU), the input-pipeline probe on phase 7's tree and the tutorial
    (Richardson-Lucy: no checkpoint of the full-width flagship here)."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    body = f"""
import importlib.util, pathlib, torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)
cpu = torch.device("cpu")
tmp = pathlib.Path({str(tmp_path)!r})
narrow = dict(n_iters=2, features=(8, 8, 8, 8))
fp32 = cs.phase_pipeline_fp32(cpu, B=4, n_check=2, **narrow)
cs.phase_generate(cpu, tmp / "data", n_train=8, n_test=3, pupil_n=16, chunk=8, errs=(0.05,), n_check=2)
res = cs.phase_measurement(cpu, "cpu", fp32, tmp / "data", tmp / "no_models", B=4, bench_batches=(2,), repeats=1,
                           mfu_batch=1, probe_batch=4, **narrow)
assert set(res["rates"]) == {{("float32", 2), ("bfloat16", 2)}} and res["launches"] == 0
assert res["tutorial"] == "Richardson-Lucy (30)" and set(res["mfu"]) == {{"float32", "bfloat16"}}
print("measurement phase ok")
"""
    res = run_blocked(body, timeout=600, env={**ENV, "PYTHONPATH": str(site), "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "measurement phase ok" in res.stdout and "equal phase 4's bit for bit: True" in res.stdout


def test_chip_smoke_scripts_phase_runs_on_cpu_without_jax(tmp_path):
    """Phase 13 at the smallest sizes in this JAX-blocked process: every
    script of the reproduction path, the measurement scripts (``scaling_torch``
    alone, with no launcher) and the science scripts, on a tree ``cli
    generate`` writes at a 16-sample pupil and a flagship checkpoint of seed-0
    weights, the widths narrowed through the phase's ``sizes``."""
    body = f"""
import importlib.util, pathlib, time, torch
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
t0 = time.perf_counter()
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)
cpu = torch.device("cpu")
tmp = pathlib.Path({str(tmp_path)!r})
w = (4, 8, 8, 8)
cs.cli.main(["generate", "--data_path", str(tmp / "data"), "--n_train", "8", "--n_test", "16", "--pupil_n", "16",
             "--chunk", "16", "--seed", "0", "--device", "cpu", "--errs", "0.01"])
state, _ = cs.create_train_state(cs.UnrolledADMMGaussian(n_iters=8, features=w), 0)
save_checkpoint(tmp / "models", "Gaussian_PnP_ADMM_8iters_MultiScale", 1, state)
fp32 = cs.phase_pipeline_fp32(cpu, B=4, n_iters=8, features=w, n_check=2)
sizes = {{"features": w, "denoiser_features": w, "sim": {{"pupil_n": 16, "pupil_pad": 32}}, "train_batch": 2,
         "n_stamps": 32, "sharded": (4, 8, 4), "n_gal": 8, "eval_batch": 4, "profile_batch": 4, "profile_repeats": 1,
         "reconcile_n_gal": 8, "trace_batch": 4, "cross_n_gal": 8, "pop_n_gal": 4}}
load_script = cs.load_script


def narrow_load_script(path):  # the reconciliation's batches cut to A-C's 4, 8, 8 and D's 8
    mod = load_script(path)
    if path.endswith("reconcile_throughput_torch.py"):
        mod.HARNESS_CONFIGS = {{k: (b, dt) for (k, (_, dt)), b in zip(mod.HARNESS_CONFIGS.items(), (4, 8, 8))}}
        mod.RESIDENT_BATCH = 8
    return mod


cs.load_script = narrow_load_script
res = cs.phase_scripts(cpu, "cpu", fp32, tmp / "data", tmp / "models", tmp / "scripts", sizes)
assert res["launches"] == {{"forward": 0, "backward": 0}}  # CPU tensors take the plain versions
print(f"scripts phase ok in {{time.perf_counter() - t0:.1f}} s")
"""
    res = run_blocked(body, timeout=600, env={**ENV, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "scripts phase ok" in res.stdout, res.stdout[-2000:]
    for line in ("equal to cli test's of the same checkpoint bit for bit: True", "byte-identical except []",
                 "full rows equal phase 4's bit for bit: True"):
        assert line in res.stdout


def test_chip_smoke_trained_phase_runs_on_cpu_without_jax(tmp_path):
    """Phase 14 in this JAX-blocked process on 4 golden stamps: the committed
    trained flagship from ``trained_port/`` against the JAX package's goldens,
    the COSMOS-layout tree through ``cli test``, ``observe`` on the CPU
    against itself, and the trained sweep on a tree ``cli generate`` writes at
    a 16-sample pupil beside a seed-0 sweep of the same galaxies."""
    body = f"""
import importlib.util, pathlib, time, torch
t0 = time.perf_counter()
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
torch.set_num_threads(2)
cpu = torch.device("cpu")
tmp = pathlib.Path({str(tmp_path)!r})
cs.cli.main(["generate", "--data_path", str(tmp / "data"), "--n_train", "2", "--n_test", "3", "--pupil_n", "16",
             "--chunk", "4", "--seed", "0", "--device", "cpu", "--errs", "0.01"])
cs.cli.main(["test", "--data_path", str(tmp / "data"), "--result_path", str(tmp / "results"), "--n_gal", "3",
             "--eval_batch_size", "2", "--snrs", "20", "100", "--device", "cpu", "--methods", "No_Deconv",
             "Unrolled_ADMM_Gaussian(8)"])
res = cs.phase_trained(cpu, "cpu", tmp / "data", tmp / "results", tmp / "trained", n_golden=4, n_gal=3, batch=2,
                       snrs=(20, 100))
assert res["launches"] == 0  # CPU tensors take the plain solve
assert res["rec_rel"] <= cs.TRAINED_REC_REL_TOL and res["cosmos_err"] <= cs.TRAINED_SHEAR_TOL
print(f"trained phase ok in {{time.perf_counter() - t0:.1f}} s")
"""
    res = run_blocked(body, timeout=600, env={**ENV, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "trained phase ok" in res.stdout, res.stdout[-2000:]
    assert "the pipeline's equal to the file's" in res.stdout
