"""What bounds the x-update solve's kernels at small batches: each against a
copy of the same bytes and against its own time at a shape with no bytes to
speak of.

    python3 scripts/profile_solve_kernels.py

On one CUDA card, at (3, 5, 7), (1, 96, 49), (32, 96, 49) and (256, 96, 49),
device time per call in a CUDA graph of ``N_ITER`` calls rotating over input
sets larger than the 50 MB L2 (``chip_smoke.graph_ms``) of

- ``x_update_solve_backward`` (28 bytes per element), through its wrapper
  (S picked by its launcher), and at the tiny shape at every forced S: S = 1
  launches without a cluster, S > 1 in clusters of S blocks, so there the
  times are the floors of a plain and of a cluster launch (``chip_smoke.py``
  phase 3 checks and times every forced S at B = 32 and 256);
- ``x_update_solve``, the forward solve (36 bytes per element, no cluster and
  no barrier): the launch floor of a plain kernel of the same kind;
- ``Tensor.copy_`` moving the backward's bytes (half read, half written): how
  fast the card moves that many bytes in one launch.

At the tiny shape a call moves next to nothing, so its time is the per-launch
floor of that kernel inside a graph.  Fails when there is no card.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import HBM_BYTES_PER_S, SPLITS, _cplx, backward_at_splits, backward_splits, graph_ms  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import card_name_and_power_limit  # noqa: E402
from galaxy_deconv_tpu_torch.ops import x_update as xu  # noqa: E402

FLOOR_SHAPE = (3, 5, 7)
SHAPES = (FLOOR_SHAPE, (1, 96, 49), (32, 96, 49), (256, 96, 49))
N_ITER = 200
L2_BYTES = 150_000_000  # the input sets in turn exceed the 50 MB L2 threefold


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_solve_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_name_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; device us per call in a CUDA "
          f"graph of {N_ITER}")
    rng = np.random.default_rng(7)
    for shape in SHAPES:
        B, n = shape[0], int(np.prod(shape))
        bwd_bytes, fwd_bytes = 28 * n + 8 * B, 36 * n + 4 * B
        n_sets = min(64, max(4, -(-L2_BYTES // fwd_bytes)))
        sets = []
        for _ in range(n_sets):
            hth = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1).to(device)
            rho = torch.from_numpy(np.abs(rng.standard_normal(B)).astype(np.float32) + 0.1).to(device)
            sets.append((_cplx(rng, shape, device), _cplx(rng, shape, device), _cplx(rng, shape, device), hth, rho))
        copies = [(torch.empty(bwd_bytes // 8, device=device), torch.randn(bwd_bytes // 8, device=device))
                  for _ in range(n_sets)]
        turn = iter(range(10**9))

        def backward():
            G, X, _, hth, rho = sets[next(turn) % n_sets]
            return xu.x_update_solve_backward(G, X, hth, rho)

        bwd = graph_ms(backward, N_ITER) * 1e3
        floors = []
        for S in SPLITS if shape == FLOOR_SHAPE else ():
            def at_s(S=S):
                G, X, _, hth, rho = sets[next(turn) % n_sets]
                return backward_at_splits(S, G, X, hth, rho)

            floors.append(f"S={S} {graph_ms(at_s, N_ITER) * 1e3:.2f}")
        forced = f" (forced: {', '.join(floors)})" if floors else ""
        fwd = graph_ms(lambda: xu.x_update_solve(*sets[next(turn) % n_sets]), N_ITER) * 1e3
        copy = graph_ms(lambda: (lambda d, s: d.copy_(s))(*copies[next(turn) % n_sets]), N_ITER) * 1e3
        print(f"{shape}: backward {bwd:.2f} us at S={backward_splits(sets[0][0])}{forced} "
              f"(bound {bwd_bytes / HBM_BYTES_PER_S * 1e6:.2f} us, "
              f"{bwd_bytes / 1e6:.3f} MB); forward {fwd:.2f} us (bound {fwd_bytes / HBM_BYTES_PER_S * 1e6:.2f} us, "
              f"{fwd_bytes / 1e6:.3f} MB); copy_ of the backward's bytes {copy:.2f} us; {n_sets} input sets ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
