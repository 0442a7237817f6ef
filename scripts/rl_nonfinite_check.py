"""Count the non-finite shear rows of Richardson-Lucy in both packages' shear
sweeps on the same galaxies.

Richardson-Lucy's update x <- x * Ht(y / Hx) / Ht(1) divides by Hx with no
guard (eps 0, as the reference): where Hx reaches the FFT's round-off the
ratio follows that round-off, which differs between FFT libraries, and could
overflow.  This runs ``run_shear_test("Richard-Lucy(N)")`` of the JAX
package's ``eval/harness.py`` and of the port's (on the CPU) over the fixed-SNR
test variants of ``--data`` and prints, per SNR, how many of the first
``--n_gal`` galaxies' (g1, g2, |g|) rows hold a non-finite value on each side,
and the first galaxy where the two sides' finiteness differs.  Equal counts
on the same galaxies mean a quirk of the reference; unequal ones a fault of
the port.

A cross-check: it needs JAX (like the tests) and runs on the CPU.  The
galaxies come from the port's ``python -m galaxy_deconv_tpu_torch generate
--device cpu``.

Usage: python scripts/rl_nonfinite_check.py --data DIR [--n_gal 10000] [--iters 100]
           [--batch 512] [--snrs 20 40 60 80 100 150 200] [--out FILE.json]
"""

import argparse
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def nonfinite_rows(rows) -> "np.ndarray":
    import numpy as np

    return ~np.isfinite(np.asarray(rows, np.float64)).all(axis=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--n_gal", type=int, default=10000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--snrs", type=int, nargs="+", default=[20, 40, 60, 80, 100, 150, 200])
    ap.add_argument("--out", default=None, help="also write the counts to this JSON file")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from galaxy_deconv_tpu.eval import harness as jharness
    from galaxy_deconv_tpu_torch.eval import harness

    method = f"Richard-Lucy({args.iters})"
    common = dict(snrs=tuple(args.snrs), n_gal=args.n_gal, batch_size=args.batch)
    report = {"method": method, "data": str(args.data), "n_gal": args.n_gal, "rows": {}}
    with tempfile.TemporaryDirectory(prefix="rl_nonfinite_") as tmp:
        t0 = time.perf_counter()
        want = jharness.run_shear_test(method, args.data, pathlib.Path(tmp) / "jax", **common)
        t1 = time.perf_counter()
        got = harness.run_shear_test(method, args.data, pathlib.Path(tmp) / "port", device="cpu", **common)
        t2 = time.perf_counter()
    print(f"{method} on {args.data}: JAX sweep {t1 - t0:.0f} s, port sweep {t2 - t1:.0f} s (CPU)")
    for snr in map(str, args.snrs):
        bad_j, bad_t = nonfinite_rows(want[snr]["rec_shear"]), nonfinite_rows(got[snr]["rec_shear"])
        differ = np.flatnonzero(bad_j != bad_t)
        report["rows"][snr] = row = {"galaxies": int(bad_j.size), "jax_nonfinite": int(bad_j.sum()),
                                     "port_nonfinite": int(bad_t.sum()),
                                     "first_difference": int(differ[0]) if differ.size else None}
        print(f"snr {snr:>3}: {row['galaxies']} galaxies, non-finite rows JAX {row['jax_nonfinite']}, port "
              f"{row['port_nonfinite']}, first galaxy where they differ {row['first_difference']}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
