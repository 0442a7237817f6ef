"""The JAX package's outputs of the trained flagship on fixed stamps, for the
port to be held against on the card.

    python scripts/flagship_goldens.py                  # writes trained_port/flagship_goldens.npz

Needs JAX, flax and orbax (it restores the orbax checkpoint in ``trained/``),
so it runs where the JAX package runs, on the CPU, like
``scripts/trained_to_port.py``; the card's machine reads the file with numpy.

Inputs: 64 stamps (obs, psf, gt, alpha): the reference's tutorial stamp of
``tests/goldens/solver_goldens.npz``, then 63 stamps from the port's
simulator on the CPU at the default optics (``simulate_batch(SEED, 63)``),
with alpha = the mean of each obs stamp, as the packed dataset computes it.
Outputs: the JAX flagship ``Gaussian_PnP_ADMM_8iters_MultiScale`` epoch
7000's fp32 reconstruction and its ``estimate_shear`` (g1, g2, |g|), and the
same with bf16 nets.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FLAGSHIP = ("Gaussian_PnP_ADMM_8iters_MultiScale", 7000)
FEATURES = (32, 64, 128, 256)
SEED = 13  # the simulator's chunk seed for stamps 1-63
N_SIMULATED = 63


def golden_inputs(n_simulated: int = N_SIMULATED, seed: int = SEED) -> dict:
    """The fixture stamp and ``n_simulated`` simulated ones, float32 numpy."""
    import numpy as np

    from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig, simulate_batch

    fixture = np.load(REPO / "tests" / "goldens" / "solver_goldens.npz")
    sim = simulate_batch(seed, n_simulated, SimulationConfig(), device="cpu")
    out = {k: np.concatenate([fixture[k][None], sim[k].numpy()]).astype(np.float32) for k in ("obs", "psf", "gt")}
    out["alpha"] = out["obs"].mean(axis=(1, 2)).astype(np.float32)
    return out


def jax_forward(variables, obs, psf, alpha, dtype: str = "float32"):
    """The JAX flagship's reconstruction and its shear, as numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from galaxy_deconv_tpu.metrics import estimate_shear
    from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian

    model = UnrolledADMMGaussian(n_iters=8, features=FEATURES, fft_impl="xla", dtype=getattr(jnp, dtype))
    rec = jax.jit(model.apply)(variables, jnp.asarray(obs), jnp.asarray(psf), jnp.asarray(alpha))
    rec = rec.astype(jnp.float32)
    return np.asarray(rec), np.asarray(jax.jit(estimate_shear)(rec))


def load_flagship(trained=REPO / "trained"):
    import jax
    import numpy as np

    from galaxy_deconv_tpu.train.checkpoint import restore_checkpoint, unpack_variables

    return jax.tree.map(np.asarray, unpack_variables(restore_checkpoint(trained, *FLAGSHIP)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(REPO / "trained_port" / "flagship_goldens.npz"))
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    t0 = time.perf_counter()
    inputs = golden_inputs()
    v = load_flagship()
    rec, shear = jax_forward(v, inputs["obs"], inputs["psf"], inputs["alpha"])
    rec_bf16, shear_bf16 = jax_forward(v, inputs["obs"], inputs["psf"], inputs["alpha"], "bfloat16")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **inputs, rec=rec, shear=shear, rec_bf16=rec_bf16, shear_bf16=shear_bf16, seed=np.int64(SEED),
             checkpoint=np.array(f"{FLAGSHIP[0]}_{FLAGSHIP[1]}epochs"))
    print(f"{out}: {len(rec)} stamps, |g| {np.abs(shear[:, 2]).min():.3g}-{np.abs(shear[:, 2]).max():.3g}, "
          f"bf16 against fp32 max |d| / max |fp32| {np.abs(rec_bf16 - rec).max() / np.abs(rec).max():.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
