"""Batched evaluation sweeps writing reference-schema results.json files
(counterpart of ``galaxy_deconv_tpu/eval/harness.py``).

``results.json`` under ``<result_path>/<method>/``::

    {"<snr>": {"rec_shear": [[g1, g2, |g|], ...], "gt_shear": ... (No_Deconv),
               "psnr_mean": ..., "psnr_median": ..., "data_root": ...},
     "time": [seconds, n_gal], "time_spread": [min, max],
     "meta": {"data_root": ..., "n_gal": ...}}

and ``results_psf_{shear,fwhm}_err.json`` keyed by the error level.  A
sweep on one device (``device``, the card unless ``"cpu"``) makes one
host-to-device copy per field, slices the batches on the device and fetches
once at the end.  Given a ``mesh`` with a process group
(``parallel/mesh.py``), the shear, time and PSF-error sweeps take the JAX
package's per-batch mesh path instead: each rank runs its contiguous shard of
every batch (a ragged last batch padded by repeating its last galaxy), the
ranks' shear rows are gathered in rank order, and rank 0 writes the results.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from galaxy_deconv_tpu_torch.data.dataset import GalaxyDataset
from galaxy_deconv_tpu_torch.metrics import estimate_shear, psnr
from galaxy_deconv_tpu_torch.models import build_model
from galaxy_deconv_tpu_torch.parallel import Mesh, all_gather_rows, barrier, is_writer, shard_rows
from galaxy_deconv_tpu_torch.pipeline import init_parameters
from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device

logger = logging.getLogger("galaxy_deconv_tpu_torch.eval")

# the benchmark's PSF-systematics sweep levels (the generator's defaults)
DEFAULT_PSF_ERRS = (0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2)

_NO_MODEL = ("No_Deconv", "FPFS")


def _load_results(path: pathlib.Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _merge_write(path: pathlib.Path, update: dict, data_root=None):
    """Merge ``update`` into the results file at ``path`` and replace it
    atomically.  When ``data_root`` differs from the file's stamp, every entry
    stamped with (or inheriting) another dataset is dropped first: sweeps of
    two datasets are not comparable."""
    path.parent.mkdir(parents=True, exist_ok=True)
    results = _load_results(path)
    if data_root is not None:
        prev = results.get("meta", {}).get("data_root")
        if prev is not None and prev != str(data_root):
            results = {
                k: v
                for k, v in results.items()
                if not (isinstance(v, dict) and k != "meta" and v.get("data_root", prev) != str(data_root))
            }
    for k, v in update.items():
        if isinstance(v, dict):
            results.setdefault(k, {}).update(v)
        else:
            results[k] = v
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(results, f)
    tmp.replace(path)


def make_apply_fn(method: str, state_dict: Optional[Mapping[str, torch.Tensor]] = None, device="cuda",
                  **model_kwargs) -> Callable:
    """(obs, psf, alpha) -> rec on ``device`` for a harness method name.

    Weights come from ``state_dict`` or, without one, from
    ``pipeline.init_parameters(model, 0)``.  Every call runs in inference mode
    with TF32 off (``utils/device.py::fp32_only``).
    """
    model = build_model(method, **model_kwargs)
    if state_dict is None:
        init_parameters(model, 0)
    else:
        model.load_state_dict(state_dict)
    model = model.to(resolve_device(device)).eval()

    @torch.inference_mode()
    def apply_fn(obs, psf, alpha):
        with fp32_only():
            return model(obs, psf, alpha)

    return apply_fn


def _apply_fn(method, state_dict, device, model_kwargs):
    return None if method in _NO_MODEL else make_apply_fn(method, state_dict, device, **model_kwargs)


def _padded(h: np.ndarray, batch_size: int) -> np.ndarray:
    """Repeat the last galaxy up to a whole number of batches."""
    pad = (-h.shape[0]) % batch_size
    return np.concatenate([h, np.repeat(h[-1:], pad, axis=0)]) if pad else h


@torch.inference_mode()
def _rec_shear_bulk(apply_fn, ds: GalaxyDataset, n: int, batch_size: int, method: str, device,
                    cache=None, cache_fields=()) -> np.ndarray:
    """(n, 3) shears of ``method`` over the first ``n`` galaxies of ``ds``.

    One host-to-device copy per field (a ragged tail padded by repeating the
    last galaxy), batches sliced on the device, one fetch at the end.
    ``cache``/``cache_fields``: a dict the caller owns, holding the device
    copies of fields constant across its sweep's variants (``psf`` over the
    SNR variants, ``obs`` over the perturbed-PSF sets).
    """
    dev = resolve_device(device)
    cache = cache if cache is not None else {}

    def upload(field):
        key = (field, n, batch_size)
        if field in cache_fields and key in cache:
            return cache[key]
        h = _padded(np.array(getattr(ds, field)[:n], np.float32), batch_size)
        # per-sample alpha = mean(obs) on the host, as GalaxyDataset.batch computes it
        out = (torch.from_numpy(h).to(dev),
               torch.from_numpy(h.mean(axis=(1, 2))).to(dev) if field == "obs" else None)
        if field in cache_fields:
            cache[key] = out
        return out

    obs, alpha = upload("obs")
    psf, _ = upload("psf")
    shears = []
    for s in range(0, obs.shape[0], batch_size):
        ob, ps, al = (a[s:s + batch_size] for a in (obs, psf, alpha))
        if method == "FPFS":
            shears.append(estimate_shear(ob, ps, deconv_psf=True))
            continue
        rec = ob if method == "No_Deconv" else apply_fn(ob, ps, al)
        shears.append(estimate_shear(rec))
    return torch.cat(shears).cpu().numpy()[:n]


@torch.inference_mode()
def _rec_shear_mesh(apply_fn, ds: GalaxyDataset, n: int, batch_size: int, method: str, mesh: Mesh) -> np.ndarray:
    """(n, 3) shears of ``method`` over the first ``n`` galaxies of ``ds``, on
    every rank: batch by batch, this rank's contiguous shard of each
    (``batch_size`` a multiple of the world size), the shards' rows gathered
    in rank order; a ragged last batch is padded by repeating its last galaxy
    and the surplus rows dropped."""
    rows = shard_rows(batch_size, mesh)
    shears = []
    for s in range(0, n, batch_size):
        idx = np.arange(s, min(s + batch_size, n))
        take = idx.shape[0]
        idx = np.concatenate([idx, np.full(batch_size - take, idx[-1])])
        b = ds.batch(idx[rows])
        ob, ps, al = (torch.from_numpy(b[k]).to(mesh.device) for k in ("obs", "psf", "alpha"))
        if method == "FPFS":
            g = estimate_shear(ob, ps, deconv_psf=True)
        else:
            g = estimate_shear(ob if method == "No_Deconv" else apply_fn(ob, ps, al))
        shears.append(all_gather_rows(g, mesh)[:take])
    return torch.cat(shears).cpu().numpy()


def _rec_shear(apply_fn, ds: GalaxyDataset, n: int, batch_size: int, method: str, device, mesh: Optional[Mesh],
               cache=None, cache_fields=()) -> np.ndarray:
    """The mesh path given a mesh with a process group, else the bulk path."""
    if mesh is None or mesh.group is None:
        return _rec_shear_bulk(apply_fn, ds, n, batch_size, method, device, cache=cache, cache_fields=cache_fields)
    return _rec_shear_mesh(apply_fn, ds, n, batch_size, method, mesh)


def _write(path: pathlib.Path, update: dict, data_root, mesh: Optional[Mesh]) -> None:
    """:func:`_merge_write` on the writing rank, every rank waiting for it."""
    if is_writer(mesh):
        _merge_write(path, update, data_root=data_root)
    barrier(mesh)


def run_shear_test(method: str, data_root, result_path, snrs: Sequence[int] = (20, 40, 60, 80, 100, 150, 200),
                   n_gal: int = 10000, batch_size: int = 512, state_dict=None, result_name: Optional[str] = None,
                   device="cuda", mesh: Optional[Mesh] = None, **model_kwargs) -> dict:
    """Shear-recovery sweep over the fixed-SNR test variants (reference
    test.py:20-107, batched); No_Deconv also writes the ground truth's shear.
    ``result_name`` names the output directory instead of ``method``; with
    ``mesh``, ``device`` is the mesh's."""
    device = device if mesh is None else mesh.device
    apply_fn = _apply_fn(method, state_dict, device, model_kwargs)
    results_file = pathlib.Path(result_path) / (result_name or method) / "results.json"
    cache: dict = {}
    for snr in snrs:
        ds = GalaxyDataset(data_root, "test", obs_variant=f"obs_{snr}")
        rec_shear = _rec_shear(apply_fn, ds, min(n_gal, len(ds)), batch_size, method, device, mesh,
                               cache=cache, cache_fields=("psf",))
        update = {str(snr): {"rec_shear": rec_shear.tolist(), "data_root": str(data_root)}}
        if method == "No_Deconv" and is_writer(mesh):
            gt = torch.from_numpy(np.array(ds.gt[:rec_shear.shape[0]], np.float32)).to(resolve_device(device))
            with torch.inference_mode():
                update[str(snr)]["gt_shear"] = estimate_shear(gt).cpu().numpy().tolist()
        update["meta"] = {"data_root": str(data_root), "n_gal": int(rec_shear.shape[0])}
        _write(results_file, update, data_root, mesh)
        logger.info("%s snr=%s: %d galaxies", method, snr, rec_shear.shape[0])
    return _load_results(results_file)


def run_time_test(method: str, data_root, result_path, n_gal: int = 10000, batch_size: int = 512, state_dict=None,
                  warmup: int = 2, repeats: int = 3, result_name: Optional[str] = None, device="cuda",
                  mesh: Optional[Mesh] = None, **model_kwargs) -> float:
    """Host-clock time of the whole sweep, model and shear measurement
    (reference test.py:110-192), over whole batches of the random-SNR split:
    ``warmup`` untimed sweeps of one batch, then the median of ``repeats``;
    the final fetch synchronises.  Writes ``time`` = [seconds, n_gal] and
    ``time_spread`` = [min, max]; returns the median seconds.  With ``mesh``
    every rank waits for the others before and after each timed sweep."""
    device = device if mesh is None else mesh.device
    apply_fn = _apply_fn(method, state_dict, device, model_kwargs)
    ds = GalaxyDataset(data_root, "test")
    # whole batches only: a padded tail costs a full batch but is not counted
    n_gal = max(batch_size, (min(n_gal, len(ds)) // batch_size) * batch_size)
    for _ in range(warmup):
        _rec_shear(apply_fn, ds, min(batch_size, n_gal), batch_size, method, device, mesh)
    times = []
    for _ in range(max(1, repeats)):
        barrier(mesh)
        t0 = time.perf_counter()
        rec = _rec_shear(apply_fn, ds, min(n_gal, len(ds)), batch_size, method, device, mesh)
        barrier(mesh)
        times.append(time.perf_counter() - t0)
    elapsed = float(np.median(times))
    _write(
        pathlib.Path(result_path) / (result_name or method) / "results.json",
        {"time": (elapsed, int(rec.shape[0])), "time_spread": (float(min(times)), float(max(times))),
         "meta": {"data_root": str(data_root)}},
        data_root, mesh,
    )
    logger.info("%s: %d galaxies, median %.3fs of %d repeats [%.3f, %.3f] (%.1f gal/s)", method, rec.shape[0],
                elapsed, len(times), min(times), max(times), rec.shape[0] / elapsed)
    return elapsed


def run_psf_error_test(method: str, data_root, result_path, errs: Sequence[float], kind: str = "shear",
                       n_gal: int = 10000, batch_size: int = 512, state_dict=None, result_name: Optional[str] = None,
                       device="cuda", mesh: Optional[Mesh] = None, **model_kwargs) -> dict:
    """PSF-systematics sweep (reference test_psf.py, batched): the true
    observations deconvolved with the perturbed PSFs ``psf_{kind}_err_{e}``."""
    device = device if mesh is None else mesh.device
    apply_fn = _apply_fn(method, state_dict, device, model_kwargs)
    results_file = pathlib.Path(result_path) / (result_name or method) / f"results_psf_{kind}_err.json"
    cache: dict = {}
    for e in errs:
        ds = GalaxyDataset(data_root, "test", psf_variant=f"psf_{kind}_err_{e}")
        rec_shear = _rec_shear(apply_fn, ds, min(n_gal, len(ds)), batch_size, method, device, mesh,
                               cache=cache, cache_fields=("obs",))
        _write(results_file,
               {str(e): {"rec_shear": rec_shear.tolist(), "data_root": str(data_root)},
                "meta": {"data_root": str(data_root)}},
               data_root, mesh)
        logger.info("%s psf_%s_err=%s done", method, kind, e)
    return _load_results(results_file)


@torch.inference_mode()
def _psnr_bulk(apply_fn, ds: GalaxyDataset, n: int, batch_size: int, method: str, device) -> np.ndarray:
    """(n,) PSNR(rec, gt) of ``method`` over the first ``n`` galaxies of
    ``ds``, in the bulk form of :func:`_rec_shear_bulk`."""
    dev = resolve_device(device)
    obs_h, psf_h, gt_h = (_padded(np.array(a[:n], np.float32), batch_size) for a in (ds.obs, ds.psf, ds.gt))
    obs, psf, gt = (torch.from_numpy(a).to(dev) for a in (obs_h, psf_h, gt_h))
    alpha = torch.from_numpy(obs_h.mean(axis=(1, 2))).to(dev)
    vals = []
    for s in range(0, obs.shape[0], batch_size):
        ob, ps, al, g = (a[s:s + batch_size] for a in (obs, psf, alpha, gt))
        rec = ob if method in _NO_MODEL else apply_fn(ob, ps, al)
        vals.append(psnr(rec, g))
    return torch.cat(vals).cpu().numpy()[:n]


def run_psnr_test(method: str, data_root, result_path, snrs: Sequence[int] = (20, 40, 60, 80, 100, 150, 200),
                  n_gal: int = 1000, batch_size: int = 512, state_dict=None, result_name: Optional[str] = None,
                  device="cuda", **model_kwargs) -> dict:
    """Reconstruction quality per SNR: mean and median PSNR(rec, gt) (the
    reference's secondary metric, utils/utils_test.py:7-25)."""
    apply_fn = _apply_fn(method, state_dict, device, model_kwargs)
    results_file = pathlib.Path(result_path) / (result_name or method) / "results.json"
    for snr in snrs:
        ds = GalaxyDataset(data_root, "test", obs_variant=f"obs_{snr}")
        vals = _psnr_bulk(apply_fn, ds, min(n_gal, len(ds)), batch_size, method, device)
        _merge_write(
            results_file,
            {str(snr): {"psnr_mean": float(np.mean(vals)), "psnr_median": float(np.median(vals)),
                        "data_root": str(data_root)}},
            data_root=data_root,
        )
        logger.info("%s snr=%s: PSNR median %.2f dB", method, snr, float(np.median(vals)))
    return _load_results(results_file)


def median_ellipticity_error(results: dict, gt_results: dict, snr) -> float:
    """The benchmark's metric (reference figures/error_snr.ipynb): the median
    over galaxies of min(|g_rec - g_gt|, 1) on the |g| component."""
    rec = np.asarray(results[str(snr)]["rec_shear"])
    gt = np.asarray(gt_results[str(snr)]["gt_shear"])
    n = min(len(rec), len(gt))
    return float(np.median(np.minimum(np.abs(rec[:n] - gt[:n]), 1)[:, 2]))
