"""MFU / roofline report of the port's benchmark pipeline (counterpart of
``scripts/mfu.py``).

Counts the FLOPs of one forward and shear measurement of
``galaxy_deconv_tpu_torch/bench.py``'s pipeline (the flagship
UnrolledADMMGaussian(8) at full width, seed-0 weights, ``bench.py``'s
stamps) with torch's ``FlopCounterMode`` (convolutions and matmuls, held
equal to the count from the layers' shapes) and the bytes of its aten ops
unfused, times it on the card as ``bench.py`` does (or takes
``--gal_per_sec``), and prints FLOPs per galaxy, sustained TFLOP/s, the
share of the H100's peak for the nets' dtype (``mfu_vs_dtype_peak``) and the
roofline position.  See ``bench.py::mfu_report`` for every field.

Usage: python scripts/mfu_torch.py [--batch 256] [--repeats 40] [--dtype bfloat16|float32]
           [--gal_per_sec N] [--cpu-flops]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from galaxy_deconv_tpu_torch.bench import DTYPES, mfu_report  # noqa: E402


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--repeats", type=int, default=40)
    parser.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    parser.add_argument("--gal_per_sec", type=float, default=None,
                        help="skip the timed run and use this measured throughput")
    parser.add_argument("--cpu-flops", action="store_true",
                        help="count on the CPU (no card needed; the FLOP counts do not depend on the device)")
    args = parser.parse_args(argv)
    if args.cpu_flops and args.gal_per_sec is None:
        parser.error("--cpu-flops requires --gal_per_sec (the CPU gives no card time)")
    report = mfu_report(args.batch, args.repeats, args.dtype, "cpu" if args.cpu_flops else "cuda", args.gal_per_sec)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
