"""Port parity: the analysis tables and figures (galaxy_deconv_tpu_torch/analysis)
against the JAX package's (galaxy_deconv_tpu/analysis) on the same results
files, in the schema the harness writes: every table and bootstrap interval
equal, the dataset-mismatch guards dropping the same cells; each figure
writes its file."""

import json

import numpy as np
import pytest

from galaxy_deconv_tpu import analysis as J
from galaxy_deconv_tpu.analysis import report as JR
from galaxy_deconv_tpu_torch import analysis as T
from galaxy_deconv_tpu_torch.analysis import report as TR

SNRS = (20, 40, 100, 200)
ERRS = (0.01, 0.05, 0.1)
METHODS = ("No_Deconv", "FPFS", "Richard-Lucy(10)", "Unrolled_ADMM_Gaussian(8)", "Wiener", "Missing")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Results files of five methods over SNRS and ERRS, 50 galaxies each;
    Wiener's SNR 100 row swept on another dataset, its file stamp the same."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(8)
    gt = rng.uniform(0, 0.6, (50, 3))
    for k, method in enumerate(METHODS[:5]):
        res = {"meta": {"data_root": "/data/a", "n_gal": 50}}
        for snr in SNRS:
            row = {"rec_shear": (gt + rng.normal(0, 0.3 / (k + 1), gt.shape)).tolist(), "data_root": "/data/a",
                   "psnr_mean": float(rng.uniform(20, 40)), "psnr_median": float(rng.uniform(20, 40))}
            if method == "No_Deconv":
                row["gt_shear"] = gt.tolist()
            if method == "Wiener" and snr == 100:
                row["data_root"] = "/data/b"
            res[str(snr)] = row
        res["time"] = [float(rng.uniform(0.1, 2)), 50]
        (root / method).mkdir()
        (root / method / "results.json").write_text(json.dumps(res))
        for kind in ("shear", "fwhm"):
            psf = {str(e): {"rec_shear": (gt + rng.normal(0, e, gt.shape)).tolist()} for e in ERRS}
            (root / method / f"results_psf_{kind}_err.json").write_text(json.dumps(psf))
    return root


def test_the_same_names_as_jax():
    assert T.__all__ == J.__all__


def test_error_table_matches_jax(results, capsys):
    got = TR.error_table(results, METHODS, SNRS)
    assert got == JR.error_table(results, METHODS, SNRS)
    assert 100 not in got["Wiener"] and 20 in got["Wiener"] and "Missing" not in got  # the guards
    assert "skipping Wiener snr=100" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["shear", "fwhm"])
def test_psf_error_table_matches_jax(results, kind):
    got = TR.psf_error_table(results, METHODS, ERRS, kind=kind)
    assert got == JR.psf_error_table(results, METHODS, ERRS, kind=kind) and set(got["FPFS"]) == set(ERRS)


@pytest.mark.parametrize("name,args", [
    ("summarize_results", (METHODS, SNRS)),
    ("summarize_psf_results", (METHODS, ERRS)),
    ("summarize_psnr_results", (METHODS, SNRS)),
    ("summarize_cis", (METHODS, (20, 100))),
])
def test_summaries_match_jax(results, name, args):
    got = getattr(TR, name)(results, *args)
    assert got == getattr(JR, name)(results, *args) and got.count("\n") >= 5


def test_summaries_without_ground_truth(tmp_path):
    # no No_Deconv sweep: an empty table and the CI note, as JAX's
    assert TR.error_table(tmp_path, METHODS) == JR.error_table(tmp_path, METHODS) == {}
    assert TR.summarize_cis(tmp_path, METHODS) == JR.summarize_cis(tmp_path, METHODS)


def test_bootstrap_ci_matches_jax():
    rng = np.random.default_rng(2)
    rec, gt = rng.normal(0, 1, (300, 3)), rng.normal(0, 1, (300, 3))
    got = TR.bootstrap_ci(rec, gt, n_boot=500, seed=4)
    assert got == JR.bootstrap_ci(rec, gt, n_boot=500, seed=4) and got[1] <= got[0] <= got[2]


def test_method_style_matches_jax():
    for m in (*METHODS, "Poisson_ADMM", "ShapeNet", "Tikhonet_Laplacian", "ADMMNet(8)"):
        assert TR.method_style(m) == JR.method_style(m)


def test_figures_write_files(results, tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    stamps = rng.uniform(0, 1, (3, 48, 48)).astype(np.float32)
    yy, xx = np.mgrid[:48, :48] - 24.0
    galaxies = np.exp(-(xx**2 / 60 + yy**2 / 25))[None].repeat(2, 0).astype(np.float32)
    traces = {"x": rng.uniform(0, 1, (2, 3, 48, 48)), "z": rng.uniform(0, 1, (2, 3, 48, 48)),
              "rho": rng.uniform(0, 1, (2, 3, 1, 1))}
    written = [
        TR.plot_loss([3.0, 2.0, 1.5], [3.1, 2.2, 1.9], 2, tmp_path, "run"),
        *(tmp_path / f"{n}.png" for n in ("snr", "time", "grid", "ellipses", "trace", "psf")),
    ]
    TR.plot_error_vs_snr(results, METHODS, SNRS, save_to=written[1])
    TR.plot_error_vs_time(results, METHODS, snr=20, save_to=written[2])
    TR.plot_reconstruction_grid({"obs": stamps, "rec": stamps}, save_to=written[3])
    TR.plot_batch_with_ellipses(galaxies, save_to=written[4])
    TR.plot_admm_trace(traces, save_to=written[5])
    TR.plot_psf_error(results, METHODS[:5], ERRS, save_to=written[6])
    for path in written:
        assert path.is_file() and path.stat().st_size > 1000, path
