"""Result loading, summary tables, and figures (counterpart of
``galaxy_deconv_tpu/analysis/report.py``, copied: numpy only, reading the
``results.json`` files the harness writes).  Each plot imports matplotlib
when it is called, so nothing here needs it at import."""

from __future__ import annotations

import json
import pathlib
from typing import Optional, Sequence

import numpy as np

METHOD_STYLE = {
    # method-substring -> (color, label); order matters (first match wins)
    "Poisson": ("tab:blue", "Unrolled ADMM (Poisson)"),
    "Unrolled_ADMM": ("tab:purple", "Unrolled ADMM"),
    "ADMMNet": ("tab:blue", "ADMMNet"),
    "Richard-Lucy": ("tab:green", "Richardson-Lucy"),
    "Tikhonet": ("tab:orange", "Tikhonet"),
    "ShapeNet": ("tab:pink", "ShapeNet"),
    "FPFS": ("tab:red", "FPFS"),
    "Wiener": ("tab:brown", "Wiener"),
    "No_Deconv": ("black", "No deconvolution"),
}


def method_style(method: str):
    for key, style in METHOD_STYLE.items():
        if key in method:
            return style
    return ("tab:gray", method)


def load_method_results(result_path, method: str, name: str = "results.json") -> dict:
    with open(pathlib.Path(result_path) / method / name) as f:
        return json.load(f)


def _median_err(rec, gt):
    n = min(len(rec), len(gt))
    return float(np.median(np.minimum(np.abs(np.asarray(rec[:n]) - np.asarray(gt[:n])), 1)[:, 2]))


def _entry_root(res: dict, key) -> Optional[str]:
    """Provenance of one per-SNR (or per-PSF-err) entry: the per-entry
    stamp when present (run_shear_test writes one per leg, so rows that
    survived a mid-method kill keep their own dataset), falling back to
    the file-level meta stamp for legacy files."""
    entry = res.get(str(key), {})
    root = entry.get("data_root") if isinstance(entry, dict) else None
    return root if root is not None else res.get("meta", {}).get("data_root")


def _dataset_mismatch(res: dict, gt_res: dict, key=None) -> bool:
    """True when two results carry provenance stamps from different
    benchmark datasets; with ``key`` the per-entry stamps are compared
    (guarding each table cell, not just the file pair).  Unstamped legacy
    results are not judged."""
    if key is not None:
        a, b = _entry_root(res, key), _entry_root(gt_res, key)
    else:
        a = res.get("meta", {}).get("data_root")
        b = gt_res.get("meta", {}).get("data_root")
    return a is not None and b is not None and a != b


def bootstrap_ci(rec, gt, n_boot: int = 2000, seed: int = 0, q=(2.5, 97.5)):
    """Percentile bootstrap CI for the benchmark metric (median over
    galaxies of min(|g_rec - g_gt|, 1) on the |g| component).

    Returns (point, lo, hi)."""
    rec, gt = np.asarray(rec), np.asarray(gt)
    n = min(len(rec), len(gt))
    err = np.minimum(np.abs(rec[:n] - gt[:n]), 1)[:, 2]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_boot, n))
    meds = np.median(err[idx], axis=1)
    lo, hi = np.percentile(meds, q)
    return float(np.median(err)), float(lo), float(hi)


def summarize_cis(
    result_path,
    methods: Sequence[str],
    snrs: Sequence[int] = (20, 100, 200),
    gt_method: str = "No_Deconv",
    n_boot: int = 2000,
) -> str:
    """Markdown table of median-error point estimates with 95% bootstrap
    CIs for the headline method comparison."""
    try:
        gt_res = load_method_results(result_path, gt_method)
    except FileNotFoundError:
        return (f"(no {gt_method} results in {result_path} — gt_shear unavailable; "
                "run the sweep with No_Deconv included to populate CIs)")
    header = "| Method | " + " | ".join(f"SNR {s}" for s in snrs) + " |"
    lines = [header, "|---" * (len(snrs) + 1) + "|"]
    for m in methods:
        try:
            res = load_method_results(result_path, m)
        except FileNotFoundError:
            continue
        if _dataset_mismatch(res, gt_res):
            continue
        cells = []
        for snr in snrs:
            if ("rec_shear" in res.get(str(snr), {})
                    and "gt_shear" in gt_res.get(str(snr), {})
                    and not _dataset_mismatch(res, gt_res, snr)):
                p, lo, hi = bootstrap_ci(res[str(snr)]["rec_shear"], gt_res[str(snr)]["gt_shear"], n_boot=n_boot)
                cells.append(f"{p:.4f} [{lo:.4f}, {hi:.4f}]")
            else:
                cells.append("—")
        lines.append(f"| {m} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def error_table(
    result_path,
    methods: Sequence[str],
    snrs: Sequence[int] = (20, 40, 60, 80, 100, 150, 200),
    gt_method: str = "No_Deconv",
) -> dict:
    """Per-method median-ellipticity-error rows (the BASELINE.md table)."""
    try:
        gt_res = load_method_results(result_path, gt_method)
    except FileNotFoundError:  # no gt sweep yet (e.g. --summarize_only on
        return {}              # a partial results dir) — degrade, don't crash
    table = {}
    for m in methods:
        try:
            res = load_method_results(result_path, m)
        except FileNotFoundError:  # method not swept (yet) — staged pipelines
            continue
        row = {}
        for snr in snrs:
            if _dataset_mismatch(res, gt_res, snr):
                import sys

                print(f"(skipping {m} snr={snr}: swept on {_entry_root(res, snr)}, but "
                      f"{gt_method}'s gt_shear is from {_entry_root(gt_res, snr)} — "
                      "rec/gt from different datasets are not comparable)", file=sys.stderr)
                continue
            if ("rec_shear" in res.get(str(snr), {})
                    and "gt_shear" in gt_res.get(str(snr), {})):
                row[snr] = _median_err(res[str(snr)]["rec_shear"], gt_res[str(snr)]["gt_shear"])
        if "time" in res:
            secs, n = res["time"]
            row["time_per_gal"] = secs / max(n, 1)
        table[m] = row
    return table


def summarize_results(result_path, methods: Sequence[str], snrs=(20, 40, 60, 80, 100, 150, 200)) -> str:
    """Markdown summary table of the benchmark."""
    table = error_table(result_path, methods, snrs)
    header = "| Method | " + " | ".join(f"SNR {s}" for s in snrs) + " | time/gal (s) |"
    sep = "|---" * (len(snrs) + 2) + "|"
    lines = [header, sep]
    for m, row in table.items():
        cells = [f"{row.get(s, float('nan')):.4f}" if s in row else "—" for s in snrs]
        t = f"{row['time_per_gal']:.2e}" if "time_per_gal" in row else "—"
        lines.append(f"| {m} | " + " | ".join(cells) + f" | {t} |")
    return "\n".join(lines)


def psf_error_table(
    result_path,
    methods: Sequence[str],
    errs: Sequence[float],
    kind: str = "shear",
    gt_method: str = "No_Deconv",
    gt_snr: int = 100,
) -> dict:
    """Per-method median-ellipticity-error rows vs systematic PSF error
    (the reference's figures/psf_error.ipynb metric, tabulated).

    Note on provenance: the perturbed-PSF sweeps run on the 1k companion
    dataset while gt_shear comes from the main sweep's ``gt_method`` row;
    both generators draw test chunks from the same key stream
    (scripts/generate_sharded.py chunk_plan), so row k is the same galaxy
    — verified bit-identical over the shared first 1000 gt stamps."""
    try:
        gt = load_method_results(result_path, gt_method)[str(gt_snr)]["gt_shear"]
    except (FileNotFoundError, KeyError):
        return {}
    table = {}
    for m in methods:
        try:
            res = load_method_results(result_path, m, f"results_psf_{kind}_err.json")
        except FileNotFoundError:
            continue
        table[m] = {e: _median_err(res[str(e)]["rec_shear"], gt) for e in errs if str(e) in res}
    return table


def summarize_psf_results(
    result_path,
    methods: Sequence[str],
    errs: Sequence[float],
    kind: str = "shear",
) -> str:
    """Markdown table of the PSF-robustness sweep (methods with results only)."""
    table = psf_error_table(result_path, methods, errs, kind=kind)
    header = f"| Method | " + " | ".join(str(e) for e in errs) + " |"
    sep = "|---" * (len(errs) + 1) + "|"
    lines = [header, sep]
    for m, row in table.items():
        cells = [f"{row[e]:.4f}" if e in row else "—" for e in errs]
        lines.append(f"| {m} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def summarize_psnr_results(
    result_path,
    methods: Sequence[str],
    snrs: Sequence[int] = (20, 40, 60, 80, 100, 150, 200),
    key: str = "psnr_median",
) -> str:
    """Markdown table of the reconstruction-quality sweep (run_psnr_test);
    methods without PSNR entries are omitted."""
    header = "| Method | " + " | ".join(f"SNR {s}" for s in snrs) + " |"
    lines = [header, "|---" * (len(snrs) + 1) + "|"]
    for m in methods:
        try:
            res = load_method_results(result_path, m)
        except FileNotFoundError:
            continue
        if not any(key in res.get(str(s), {}) for s in snrs):
            continue
        cells = [f"{res[str(s)][key]:.2f}" if key in res.get(str(s), {}) else "—" for s in snrs]
        lines.append(f"| {m} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def plot_loss(train_loss, val_loss, epoch_min: int, save_path, model_name: str):
    """Loss curves (reference utils/utils_plot.py:62-75)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = np.arange(1, len(train_loss) + 1)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(epochs, train_loss, label="train")
    ax.plot(epochs, val_loss, label="val")
    if 0 <= epoch_min < len(val_loss):
        ax.axvline(epoch_min + 1, ls="--", c="gray", lw=0.8, label=f"best (ep {epoch_min + 1})")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(model_name)
    ax.legend()
    out = pathlib.Path(save_path) / f"{model_name}_loss.jpg"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_error_vs_snr(
    result_path,
    methods: Sequence[str],
    snrs=(20, 40, 60, 80, 100, 150, 200),
    save_to: Optional[str] = None,
):
    """Median ellipticity error vs SNR (reference figures/error_snr.ipynb)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = error_table(result_path, methods, snrs)
    fig, ax = plt.subplots(figsize=(7, 5))
    for m, row in table.items():
        xs = [s for s in snrs if s in row]
        ys = [row[s] for s in xs]
        color, label = method_style(m)
        ax.plot(xs, ys, "o-", color=color, label=f"{label} ({m})" if label != m else m)
    ax.set_xlabel("SNR")
    ax.set_ylabel("median ellipticity error")
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_error_vs_time(
    result_path,
    methods: Sequence[str],
    snr: int = 100,
    save_to: Optional[str] = None,
):
    """Accuracy-vs-speed scatter (reference figures/error_time.ipynb):
    median ellipticity error at one SNR against time per galaxy."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = error_table(result_path, methods, (snr,))
    fig, ax = plt.subplots(figsize=(6, 5))
    for m, row in table.items():
        if snr not in row or "time_per_gal" not in row:
            continue
        color, label = method_style(m)
        ax.scatter(row["time_per_gal"], row[snr], color=color, label=m)
    ax.set_xlabel("time per galaxy (s)")
    ax.set_ylabel(f"median ellipticity error (SNR {snr})")
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_reconstruction_grid(
    panels: dict,
    save_to: Optional[str] = None,
    max_rows: int = 6,
):
    """Gallery of stamps (reference figures/grid_plot.ipynb / press.ipynb):
    one column per entry in ``panels`` (e.g. {"observed": obs, "ADMM(8)":
    rec, "ground truth": gt}, each (B, H, W)), one row per galaxy."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(panels)
    rows = min(max_rows, min(np.asarray(v).shape[0] for v in panels.values()))
    fig, axes = plt.subplots(rows, len(names), figsize=(2.2 * len(names), 2.2 * rows), squeeze=False)
    for r in range(rows):
        for c, name in enumerate(names):
            img = np.asarray(panels[name][r])
            ax = axes[r][c]
            ax.imshow(img, cmap="magma", origin="lower")
            ax.set_xticks([])
            ax.set_yticks([])
            if r == 0:
                ax.set_title(name, fontsize=9)
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_batch_with_ellipses(
    images,
    params=None,
    peak_pos: float = 0.5,
    ncols: int = 8,
    save_to: Optional[str] = None,
):
    """Stamp gallery with the fitted iso-intensity ellipse drawn over each
    galaxy (reference ``plot_batch_with_ellipses``, utils/fit_ellipse.py:183-250).

    ``images``: (B, H, W).  ``params``: optional (B, 5) ellipse parameters in
    the (cy, cx, theta, a, b) row/col convention of
    :func:`galaxy_deconv_tpu_torch.losses.best_ellipse.ellipse_params`; when
    omitted they are fitted here at the ``peak_pos`` intensity level of the
    min-max-normalized stamps.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    if params is None:
        import torch

        from galaxy_deconv_tpu_torch.losses.best_ellipse import ellipse_coeffs, ellipse_params, min_max_normalize

        _, H, W = images.shape
        conics = ellipse_coeffs(min_max_normalize(torch.as_tensor(images, dtype=torch.float32)), (peak_pos,))
        params = ellipse_params(conics, H, W)[0].numpy()
    params = np.asarray(params)

    B = images.shape[0]
    ncols = min(ncols, B)
    nrows = (B + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(2.0 * ncols, 2.0 * nrows), squeeze=False)
    t = np.linspace(0.0, 2 * np.pi, 128)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.set_xticks([])
        ax.set_yticks([])
        if i >= B:
            ax.axis("off")
            continue
        ax.imshow(images[i], cmap="magma", origin="lower")
        cy, cx, theta, a, b = params[i]
        # the conic's 'x' axis is the image ROW (weighted_ellipse_fit
        # convention), so the a-axis rotates from row toward col
        ct, st = np.cos(theta), np.sin(theta)
        ys = cy + a * np.cos(t) * ct - b * np.sin(t) * st
        xs = cx + a * np.cos(t) * st + b * np.sin(t) * ct
        ax.plot(xs, ys, color="cyan", lw=1.0)
        ax.plot([cx], [cy], "+", color="cyan", ms=6)
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_admm_trace(
    traces: dict,
    sample: int = 0,
    save_to: Optional[str] = None,
):
    """Per-iteration ADMM internals (reference figures/analysis.ipynb):
    ``traces`` is the ``analysis=True`` output of the unrolled solvers —
    {"x": (B, n, H, W), "z": ..., "u": ..., "rho": (B, n, 1, 1)}.  Plots the
    x and z estimates per iteration for one galaxy plus the predicted
    penalty schedule."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(traces["x"][sample])
    z = np.asarray(traces["z"][sample])
    rho = np.asarray(traces["rho"][sample]).reshape(-1)
    n = x.shape[0]
    fig, axes = plt.subplots(3, n, figsize=(1.8 * n, 5.6), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(x[i], cmap="magma", origin="lower")
        axes[0][i].set_title(f"x$_{{{i + 1}}}$", fontsize=8)
        axes[1][i].imshow(z[i], cmap="magma", origin="lower")
        axes[1][i].set_title(f"z$_{{{i + 1}}}$", fontsize=8)
        for r in (0, 1):
            axes[r][i].set_xticks([])
            axes[r][i].set_yticks([])
    gs = axes[2][0].get_gridspec()
    for ax in axes[2]:
        ax.remove()
    ax = fig.add_subplot(gs[2, :])
    ax.plot(np.arange(1, n + 1), rho, "o-")
    ax.set_xlabel("iteration")
    ax.set_ylabel(r"$\rho_i$")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_psf_error(
    result_path,
    methods: Sequence[str],
    errs: Sequence[float],
    kind: str = "shear",
    gt_method: str = "No_Deconv",
    gt_snr: int = 100,
    save_to: Optional[str] = None,
):
    """Error vs systematic PSF error (reference figures/psf_error.ipynb)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt_res = load_method_results(result_path, gt_method)
    gt = gt_res[str(gt_snr)]["gt_shear"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for m in methods:
        res = load_method_results(result_path, m, f"results_psf_{kind}_err.json")
        xs = [e for e in errs if str(e) in res]
        ys = [_median_err(res[str(e)]["rec_shear"], gt) for e in xs]
        color, label = method_style(m)
        ax.plot(xs, ys, "o-", color=color, label=m)
    ax.set_xlabel(f"PSF {kind} error")
    ax.set_ylabel("median ellipticity error")
    ax.set_xscale("log")
    ax.legend(fontsize=7)
    if save_to:
        fig.savefig(save_to, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
