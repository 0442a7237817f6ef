"""Rules of the PyTorch port: it runs where JAX does not exist.

Every module of galaxy_deconv_tpu_torch and chip_smoke.py imports with jax,
flax, orbax and the JAX package blocked, and chip_smoke.py's pipeline phases
run on the CPU (at a tiny size, through the plain x-update solve) with them
blocked.  chip_smoke.py exits non-zero and prints no result without a card,
and when it stands alone in a directory."""

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


def run_blocked(body: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _BLOCKER + body], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=ENV)


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
spec = importlib.util.spec_from_file_location("chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len({port_modules()!r}))
"""
    res = run_blocked(body)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(port_modules())}" in res.stdout


def test_blocker_blocks():
    res = run_blocked("import galaxy_deconv_tpu.ops.fourier")
    assert res.returncode != 0 and "blocked import" in res.stderr


@pytest.mark.parametrize("path", [REPO / "chip_smoke.py", *sorted(PORT.rglob("*.py"))],
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
