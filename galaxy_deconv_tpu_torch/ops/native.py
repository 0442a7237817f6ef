"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``_build/lib<name>-<digest>.so`` inside the
package (a directory git ignores).  The digest covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.  A
source is compiled on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_LIBRARIES: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library's path and nvcc's output (``-Xptxas -v`` included; empty when
    nothing was built).  Raises with nvcc's output on failure."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True,
                             timeout=NVCC_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent builder never loads a half-written file
    finally:
        tmp.unlink(missing_ok=True)
    return lib, res.stdout + res.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBRARIES:
        _LIBRARIES[name] = ctypes.CDLL(str(build(name)[0]))
    return _LIBRARIES[name]
