"""Run the benchmark's method matrix on the card and write its results and
tables (counterpart of ``scripts/run_benchmark.py``).

The reference's test.py method matrix on the simulated LSST benchmark: the
classical baselines, the transplanted reference Tikhonet checkpoints (when
the reference's ``.pth`` files are present) and the trained models, found
by run name in ``--ckpt`` first, then in ``--trained`` (port checkpoints, as
``scripts/export_trained_torch.py`` or ``scripts/trained_to_port.py`` write
them).  The sweeps go through ``eval/harness.py``; the tables come from
``analysis/`` and replace the marked blocks of ``<result>/RESULTS.md``
(created with every block's markers when it does not exist).

Usage: python scripts/run_benchmark_torch.py [--data datasets/LSST_23.5_deconv_tpu]
         [--result results_torch] [--n_gal 1000] [--ckpt saved_models_online_torch] [--device cpu]
"""

import argparse
import logging
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from galaxy_deconv_tpu_torch.analysis import (  # noqa: E402
    summarize_cis,
    summarize_psf_results,
    summarize_psnr_results,
    summarize_results,
)
from galaxy_deconv_tpu_torch.eval import (  # noqa: E402
    DEFAULT_PSF_ERRS,
    run_psf_error_test,
    run_psnr_test,
    run_shear_test,
    run_time_test,
)
from galaxy_deconv_tpu_torch.train.checkpoint import find_checkpoint, restore_checkpoint, unpack_variables  # noqa: E402
from galaxy_deconv_tpu_torch.utils.convert_torch import load_reference_tikhonet  # noqa: E402

SNRS = (20, 40, 60, 80, 100, 150, 200)

# result-dir name -> (registry build name, checkpoint run name)
TRAINED_SPECS = {
    "Unrolled_ADMM_Gaussian(8)": ("Unrolled_ADMM_Gaussian(8)", "Gaussian_PnP_ADMM_8iters_MultiScale"),
    # continuation training of the flagship (train_zoo --suffix _cont)
    "Unrolled_ADMM_Gaussian(8)_cont": ("Unrolled_ADMM_Gaussian(8)", "Gaussian_PnP_ADMM_8iters_MultiScale_cont"),
    "Unrolled_ADMM_Gaussian(4)": ("Unrolled_ADMM_Gaussian(4)", "Gaussian_PnP_ADMM_4iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(2)": ("Unrolled_ADMM_Gaussian(2)", "Gaussian_PnP_ADMM_2iters_MultiScale"),
    "Tikhonet_Laplacian_tpu": ("Tikhonet_Laplacian", "Tikhonet_Laplacian_MultiScale"),
    "ShapeNet_tpu": ("ShapeNet", "ShapeNet_Laplacian"),
    # continuation of the shape-constraint training (training-length ablation)
    "ShapeNet_tpu_cont": ("ShapeNet", "ShapeNet_Laplacian_cont"),
    # continuation toward the reference's ~2M-sample training budget
    "ShapeNet_tpu_2M": ("ShapeNet", "ShapeNet_Laplacian_2M"),
    "Unrolled_ADMM_Poisson(8)": ("Unrolled_ADMM(8)", "Poisson_PnP_ADMM_8iters_MultiScale"),
    # bounded-rho schedule variants (models/unrolled_admm_gaussian.py rho_bounds)
    "Unrolled_ADMM_Gaussian(8)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(8)",
                                          "Gaussian_PnP_ADMM_8iters_Bounded_MultiScale"),
    "Unrolled_ADMM_Gaussian(4)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(4)",
                                          "Gaussian_PnP_ADMM_4iters_Bounded_MultiScale"),
    "Unrolled_ADMM_Gaussian(2)_bounded": ("Unrolled_ADMM_Gaussian_Bounded(2)",
                                          "Gaussian_PnP_ADMM_2iters_Bounded_MultiScale"),
    # reference-protocol runs (scripts/reference_protocol_torch.py)
    "Unrolled_ADMM_Gaussian(8)_refproto": ("Unrolled_ADMM_Gaussian(8)",
                                           "RefProto_Gaussian_PnP_ADMM_8iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(4)_refproto": ("Unrolled_ADMM_Gaussian(4)",
                                           "RefProto_Gaussian_PnP_ADMM_4iters_MultiScale"),
    "Unrolled_ADMM_Gaussian(2)_refproto": ("Unrolled_ADMM_Gaussian(2)",
                                           "RefProto_Gaussian_PnP_ADMM_2iters_MultiScale"),
    "ShapeNet_refproto": ("ShapeNet", "RefProto_ShapeNet_Laplacian_Shape"),
    # the loss-x-model training matrix (reference train.py:58-74)
    "Unrolled_ADMM_Gaussian(8)_Shape": ("Unrolled_ADMM_Gaussian(8)", "Gaussian_PnP_ADMM_8iters_Shape"),
    "Unrolled_ADMM_Gaussian(4)_Shape": ("Unrolled_ADMM_Gaussian(4)", "Gaussian_PnP_ADMM_4iters_Shape"),
    "Unrolled_ADMM_Gaussian(2)_MomentBased": ("Unrolled_ADMM_Gaussian(2)", "Gaussian_PnP_ADMM_2iters_MomentBased"),
    "Unrolled_ADMM_Gaussian(2)_BestEllipse": ("Unrolled_ADMM_Gaussian(2)", "Gaussian_PnP_ADMM_2iters_BestEllipse"),
}

# the reference's shipped checkpoints, carried across by utils/convert_torch.py
REF_TRANSPLANTS = {
    "Tikhonet_Laplacian": ("Tikhonet_Laplacian", "Tikhonet_Laplacian_50epochs.pth"),
    "Tikhonet_Identity": ("Tikhonet", "Tikhonet_Identity_50epochs.pth"),
    "ShapeNet": ("ShapeNet", "ShapeNet_Laplacian_50epochs.pth"),
}

BASELINES = ("No_Deconv", "FPFS", "Wiener", "Richard-Lucy(10)", "Richard-Lucy(20)", "Richard-Lucy(30)",
             "Richard-Lucy(50)", "Richard-Lucy(100)")

# the methods of the confidence-interval table, in its row order
CI_METHODS = (
    "Unrolled_ADMM_Gaussian(8)_bounded", "Unrolled_ADMM_Gaussian(4)_bounded",
    "Unrolled_ADMM_Gaussian(2)_bounded", "Unrolled_ADMM_Gaussian(8)",
    "Unrolled_ADMM_Gaussian(4)", "Unrolled_ADMM_Gaussian(2)",
    "Unrolled_ADMM_Gaussian(8)_refproto", "Unrolled_ADMM_Gaussian(4)_refproto",
    "Unrolled_ADMM_Gaussian(2)_refproto", "ShapeNet_refproto",
    "Unrolled_ADMM_Gaussian(8)_Shape", "Unrolled_ADMM_Gaussian(4)_Shape",
    "ShapeNet", "ShapeNet_tpu", "ShapeNet_tpu_2M", "Tikhonet_Laplacian",
    "Richard-Lucy(30)", "FPFS", "No_Deconv")

# the marked blocks of RESULTS.md, in the order a new file holds them
BLOCKS = ("BENCHMARK TABLE", "CI TABLE", "PSF SHEAR TABLE", "PSF FWHM TABLE", "PSNR TABLE")

# (result name, build name) of the ADMMNet assemblies around each trained denoiser
ADMMNETS = {
    "ResUNet_MultiScale": (("ADMMNet", "ADMMNet"), ("ADMMNet_scaled", "ADMMNet_scaled"),
                           ("ADMMNet_fixed", "ADMMNet_fixed")),
    "ResUNet_Unit_MultiScale": (("ADMMNet_unit", "ADMMNet"), ("ADMMNet_unit_fixed", "ADMMNet_fixed")),
}


def denoiser_keys(state_dict: dict) -> dict:
    """The frozen ResUNet's entries of a ``ResUNet_*`` run's state_dict: an
    ADMMNet's whole state_dict (both name it ``resunet.``)."""
    return {k: v for k, v in state_dict.items() if k.startswith("resunet.")}


def discover_methods(ckpt, trained, ref_models, admm8_epoch: int = 0) -> dict:
    """The method matrix: result name -> {"build_name", "state_dict"} (empty
    for the baselines), with every checkpoint found."""
    methods: dict[str, dict] = {m: {} for m in BASELINES}
    for result_name, (build_name, fname) in REF_TRANSPLANTS.items():
        ref_pth = pathlib.Path(ref_models) / fname
        if ref_pth.exists():
            methods[result_name] = {"state_dict": load_reference_tikhonet(str(ref_pth)), "build_name": build_name}
    for result_name, (build_name, ckpt_name) in TRAINED_SPECS.items():
        src, ep = find_checkpoint(ckpt_name, ckpt, trained)
        if result_name == "Unrolled_ADMM_Gaussian(8)" and admm8_epoch:
            src, ep = pathlib.Path(ckpt), admm8_epoch
        if not ep:
            continue
        methods[result_name] = {"state_dict": unpack_variables(restore_checkpoint(src, ckpt_name, ep)),
                                "build_name": build_name}
        print(f"loaded {result_name} from {src}/{ckpt_name} step {ep}")
    # ADMMNet: the frozen-denoiser ablation around a separately trained ResUNet
    for run, assemblies in ADMMNETS.items():
        src, ep = find_checkpoint(run, ckpt, trained)
        if not ep:
            continue
        sd = denoiser_keys(unpack_variables(restore_checkpoint(src, run, ep)))
        for result_name, build_name in assemblies:
            methods[result_name] = {"state_dict": sd, "build_name": build_name}
        print(f"assembled {', '.join(r for r, _ in assemblies)} from {run} step {ep}")
    return methods


def replace_block(out: pathlib.Path, tag: str, content: str) -> bool:
    """Put ``content`` between ``out``'s ``<!-- tag START/END -->`` markers;
    False when the file holds no such markers."""
    start, end = f"<!-- {tag} START -->", f"<!-- {tag} END -->"
    if not (out.exists() and start in out.read_text()):
        return False
    text = out.read_text()
    pre, rest = text.split(start, 1)
    _, post = rest.split(end, 1)
    out.write_text(pre + f"{start}\n{content}\n{end}" + post)
    return True


def results_skeleton(n_gal: int) -> str:
    """A new ``RESULTS.md``: its header and every block's markers."""
    header = (
        "# RESULTS — PyTorch/CUDA port benchmark\n\n"
        f"Simulated LSST benchmark (the port's simulator), {n_gal} test galaxies/SNR,\n"
        "median ellipticity error = median min(|g_rec - g_gt|, 1) on the |g| component\n"
        "(gt_shear measured on noiseless gt stamps, same estimator).  Timing is the\n"
        "full batched deconvolve+measure pipeline per galaxy on one card.\n\n"
    )
    blocks = "\n\n".join(f"<!-- {tag} START -->\n<!-- {tag} END -->" for tag in BLOCKS)
    return header + blocks + "\n\nReference baselines: see BASELINE.md.\n"


def write_tables(result, all_methods, n_gal: int) -> pathlib.Path:
    """Every table of the results under ``result`` (the methods whose files
    exist) into the marked blocks of ``<result>/RESULTS.md``."""
    out = pathlib.Path(result) / "RESULTS.md"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(results_skeleton(n_gal))
    tables = {"BENCHMARK TABLE": summarize_results(result, all_methods, SNRS)}
    ci_methods = [m for m in CI_METHODS if m in all_methods]
    if ci_methods:
        tables["CI TABLE"] = summarize_cis(result, ci_methods)
    for kind in ("shear", "fwhm"):
        tables[f"PSF {kind.upper()} TABLE"] = summarize_psf_results(result, all_methods, DEFAULT_PSF_ERRS, kind=kind)
    tables["PSNR TABLE"] = summarize_psnr_results(result, all_methods, SNRS)
    for tag, table in tables.items():
        if not replace_block(out, tag, table):
            print(f"(no {tag} markers in {out}; table printed below)\n{table}")
    print(tables["BENCHMARK TABLE"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="datasets/LSST_23.5_deconv_tpu")
    parser.add_argument("--psf_data", default=None,
                        help="dataset root for the perturbed-PSF robustness sweeps (default: --data)")
    parser.add_argument("--psf_n_gal", type=int, default=None, help="galaxies for the PSF sweeps (default: --n_gal)")
    parser.add_argument("--psnr_n_gal", type=int, default=None, help="galaxies for the PSNR sweep (default: --n_gal)")
    parser.add_argument("--result", default="results_torch")
    parser.add_argument("--n_gal", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=250)
    parser.add_argument("--ckpt", default="saved_models_online_torch")
    parser.add_argument("--trained", default="trained_torch",
                        help="directory of port checkpoints searched after --ckpt")
    parser.add_argument("--ref_models", default="reference/saved_models",
                        help="the reference repository's saved_models (its .pth files are used where present)")
    parser.add_argument("--admm8_epoch", type=int, default=0, help="0 = the best-validation epoch")
    parser.add_argument("--skip_time", action="store_true")
    parser.add_argument("--skip_shear", action="store_true",
                        help="leave accuracy sweeps untouched (e.g. a time-table refresh)")
    parser.add_argument("--skip_psf", action="store_true")
    parser.add_argument("--skip_psnr", action="store_true")
    parser.add_argument("--only", nargs="*", default=None, help="restrict to these result names")
    parser.add_argument("--summarize_only", action="store_true",
                        help="skip all eval sweeps; refresh the tables from the results already on disk")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    methods = discover_methods(args.ckpt, args.trained, args.ref_models, args.admm8_epoch)
    # the tables cover the whole matrix found, even when --only restricts the sweeps run now
    all_methods = list(methods)
    if args.only:
        methods = {k: v for k, v in methods.items() if k in args.only}
    if args.summarize_only:
        methods = {}

    def sweep_args(method):
        kw = dict(methods[method])
        return kw.pop("build_name", method), dict(result_name=method, batch_size=args.batch,
                                                  device=args.device, **kw)

    for method in methods:
        build_name, kw = sweep_args(method)
        if not args.skip_shear:
            run_shear_test(build_name, args.data, args.result, snrs=SNRS, n_gal=args.n_gal, **kw)
        if not args.skip_time:
            run_time_test(build_name, args.data, args.result, n_gal=args.n_gal, warmup=1, **kw)
        if not args.skip_psnr and method != "FPFS":  # FPFS reconstructs nothing
            run_psnr_test(build_name, args.data, args.result, snrs=SNRS, n_gal=args.psnr_n_gal or args.n_gal, **kw)

    if not args.skip_psf:
        # the whole matrix, as the reference's test_psf.py; No_Deconv never
        # touches the PSF (its rows would be constant), FPFS does
        for method in methods:
            if method == "No_Deconv":
                continue
            build_name, kw = sweep_args(method)
            for kind in ("shear", "fwhm"):
                run_psf_error_test(build_name, args.psf_data or args.data, args.result, errs=DEFAULT_PSF_ERRS,
                                   kind=kind, n_gal=args.psf_n_gal or args.n_gal, **kw)

    out = write_tables(args.result, all_methods, args.n_gal)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
