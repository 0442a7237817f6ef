"""Input-pipeline throughput probe of the port (counterpart of
``scripts/bench_pipeline.py``; the reference's utils/num_workers.py analog:
the port's two input paths are the simulator on the device and the
packed-memmap dataset reader).

Measures galaxies/sec of
  * ``data/simulate.py::simulate_batch`` (the online-training input path)
    per batch size: device time from CUDA events around ``--repeats`` calls
    after a warm-up (host clock on the CPU);
  * ``GalaxyDataset`` + ``iterate_batches`` host reads (the offline path) of
    the train split that ``--data`` names, ``--passes`` shuffled passes per
    batch size, each pass's rate reported (their median, least and most);
  * the same passes with each batch's obs, psf, alpha and gt copied to the
    card, from the reader's pageable arrays and through pinned staging
    buffers (a copy with ``non_blocking``), each pass ending in a
    synchronise.

A split read just after it was written sits in the page cache, as it does
from a training run's second epoch on; the reads then measure the reader and
the copies, not the disk.  A split of a few batches reads in milliseconds:
it shows that the probe works, not what the reader sustains.

Usage: python scripts/bench_pipeline_torch.py [--data datasets/LSST_23.5_deconv_tpu]
         [--device cpu] [--batches 64 256 1024] [--repeats 10] [--passes 3]
"""

import argparse
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data import GalaxyDataset, SimulationConfig, iterate_batches  # noqa: E402
from galaxy_deconv_tpu_torch.data.simulate import simulate_batch  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import resolve_device  # noqa: E402

FIELDS = ("obs", "psf", "alpha", "gt")


def simulate_rate(B: int, repeats: int, cfg: SimulationConfig, device: torch.device) -> tuple[float, str]:
    """gal/s of ``simulate_batch`` at batch ``B`` and what clock gave it."""
    simulate_batch(0, B, cfg, device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(repeats):
            simulate_batch(i, B, cfg, device)
        return repeats * B / (time.perf_counter() - t0), "host clock"
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(repeats):
        simulate_batch(i, B, cfg, device)
    end.record()
    end.synchronize()
    return repeats * B / (start.elapsed_time(end) / 1e3), "CUDA events"


def read_rates(ds: GalaxyDataset, B: int, device: torch.device, passes: int = 1) -> dict:
    """gal/s of each of ``passes`` shuffled passes of batches of ``B``: the
    host reads alone, and on a card with each batch copied from pageable
    arrays and through pinned staging buffers."""

    def one_pass(seed, copy=None):
        n = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for b in iterate_batches(ds, B, shuffle=True, seed=seed):
            if copy is not None:
                copy(b)
            n += b["obs"].shape[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return n / (time.perf_counter() - t0)

    def all_passes(copy=None):
        return [one_pass(seed, copy) for seed in range(passes)]

    rates = {"host": all_passes()}
    if device.type != "cuda":
        return rates
    staging = {k: torch.empty((B, 48, 48) if k != "alpha" else (B,), pin_memory=True) for k in FIELDS}

    def pageable(b):
        return [torch.from_numpy(b[k]).to(device) for k in FIELDS]

    def pinned(b):
        out = []
        for k in FIELDS:
            staging[k].numpy()[...] = b[k]
            out.append(staging[k].to(device, non_blocking=True))
        # the staging buffers are refilled by the next batch: wait for these copies first
        torch.cuda.current_stream(device).synchronize()
        return out

    rates["pageable"] = all_passes(pageable)
    rates["pinned"] = all_passes(pinned)
    return rates


def spread(rates: list) -> str:
    return f"{statistics.median(rates):,.0f} [{min(rates):,.0f}, {max(rates):,.0f}]"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--batches", type=int, nargs="*", default=[64, 256, 1024])
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--passes", type=int, default=3, help="passes over the train split per batch size and copy")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = SimulationConfig()
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    out = {"simulate": {}, "read": {}}
    for B in args.batches:
        rate, clock = simulate_rate(B, args.repeats, cfg, device)
        out["simulate"][B] = rate
        print(f"simulate_batch B={B}: {rate:,.0f} gal/s ({B / rate * 1e3:.1f} ms/batch, {clock})")

    root = pathlib.Path(args.data)
    if not root.exists():
        print(f"(no dataset at {root}; skipping reader benchmark)")
        return out
    ds = GalaxyDataset(root, "train")
    for B in args.batches:
        if B > len(ds):
            continue
        rates = out["read"][B] = read_rates(ds, B, device, args.passes)
        text = {"host": "on the host", "pageable": "with pageable copies to the card",
                "pinned": "through pinned buffers"}
        print(f"dataset read B={B}, {len(ds)} galaxies, {args.passes} passes, gal/s median [least, most]: "
              + "; ".join(f"{spread(r)} {text[k]}" for k, r in rates.items()))
    return out


if __name__ == "__main__":
    main()
