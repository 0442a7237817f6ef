"""Sharded benchmark-dataset generation (counterpart of ``scripts/generate_sharded.py``).

``data/dataset.py::generate_dataset`` renders each chunk from a seed of its
own (``chunk_plan``: ``numpy.random.SeedSequence(seed).spawn(2)``, one
child for the train split and one for the test split, each spawning one seed
per chunk), so chunks are independently reproducible.  This script lets N
worker processes each simulate an interleaved subset of the TEST chunks (the
expensive part: the random-SNR split, the 7 fixed-SNR variants and the 20
perturbed-PSF sets), worker 0 the train split too, and a final merge
assembles ``generate_dataset``'s layout: the same files, byte for byte, as
one ``generate_dataset`` call with the same seed and chunk on the same kind
of device.

  python scripts/generate_sharded_torch.py worker --shard 0 --n_shards 2 ... [--device cpu]
  python scripts/generate_sharded_torch.py merge ...
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from galaxy_deconv_tpu_torch.data.dataset import (PSF_ERRS as ERRS, SNRS, chunk_plan, dataset_info,  # noqa: E402
                                                  render_test_chunk, write_chunks, write_info, write_split)
from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import resolve_device  # noqa: E402


def run_worker(root: pathlib.Path, shard: int, n_shards: int, plan: tuple, cfg: SimulationConfig, device,
               errs=ERRS) -> list:
    """Worker ``shard`` of ``n_shards``: the train split when it is worker 0,
    then every ``n_shards``-th test chunk not yet done, each to
    ``_shards/chunk_NNNN.npz`` and its marker; the chunks it rendered."""
    train_keys, test_keys = plan
    shard_dir = root / "_shards"
    shard_dir.mkdir(parents=True, exist_ok=True)
    if shard == 0:
        write_split(root / "train", train_keys, cfg, device)
        print("train split done", flush=True)
    done = []
    for ci, (k, n) in enumerate(test_keys):
        marker = shard_dir / f"chunk_{ci:04d}.done"
        if ci % n_shards != shard or marker.exists():
            continue
        np.savez(shard_dir / f"chunk_{ci:04d}.npz", **render_test_chunk(k, n, cfg, device, SNRS, errs, errs))
        marker.touch()
        done.append(ci)
        print(f"chunk {ci}/{len(test_keys)} done", flush=True)
    return done


def run_merge(root: pathlib.Path, plan: tuple, info: dict) -> None:
    """Stack every test chunk's arrays into ``test/`` and write ``info.json``."""
    test_keys = plan[1]
    files = [root / "_shards" / f"chunk_{ci:04d}.npz" for ci in range(len(test_keys))]
    missing = [f.name for f in files if not f.exists()]
    if missing:
        raise SystemExit(f"missing {len(missing)} chunks, e.g. {missing[:3]}")
    write_chunks(root / "test", (np.load(f) for f in files), sum(n for _, n in test_keys))
    write_info(root, info)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["worker", "merge"])
    p.add_argument("--root", default="datasets/LSST_23.5_deconv_tpu_10k_torch")
    p.add_argument("--seed", type=int, default=31415)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_test", type=int, default=10000)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--n_shards", type=int, default=2)
    p.add_argument("--skip_psf_errs", action="store_true",
                   help="omit the 20 perturbed-PSF sets (generate them in a separate\n"
                        "smaller dataset: they cost ~5x the rest of the test split)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = SimulationConfig()
    root = pathlib.Path(args.root)
    errs = () if args.skip_psf_errs else ERRS
    plan = chunk_plan(args.seed, args.n_train, args.n_test, args.chunk)
    if args.mode == "worker":
        run_worker(root, args.shard, args.n_shards, plan, cfg, resolve_device(args.device), errs)
        return 0
    run_merge(root, plan, dataset_info(args.n_train, args.n_test, args.seed, cfg, snrs=list(SNRS),
                                       shear_errs=list(errs), fwhm_errs=list(errs)))
    print("merge complete:", root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
