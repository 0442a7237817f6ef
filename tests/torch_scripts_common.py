"""Helpers shared by the tests of the port's scripts
(``tests/test_torch_scripts_{repro,measure,science}.py``): loading a script
from its file, one torch thread, each file's time, and seeded flax
variables for the JAX models those tests hold the port against."""

import importlib.util
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(pupil_n=16, pupil_pad=32)  # a 16-sample pupil: seconds to render on the CPU
NARROW = (4, 8, 16, 32)  # the flagship's denoiser widths in these tests


def load(name: str):
    """``scripts/<name>.py`` as a fresh module."""
    path = REPO / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def teardown_module(module):
    """Print the file's time since its ``T0`` (set at its import)."""
    print(f"\n{pathlib.Path(module.__file__).name}: {time.perf_counter() - module.T0:.1f} s")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: OpenMP teams stall beside the tier-1 run's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_variables(model, shape_args, seed: int) -> dict:
    """Seeded numpy variables in the shapes of ``model.init``'s tree on
    ``shape_args`` (traced with ``jax.eval_shape``: an un-jitted init of the
    8-iteration model takes ~30 s on the CPU)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *shape_args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
