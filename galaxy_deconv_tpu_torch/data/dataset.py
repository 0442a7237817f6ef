"""The packed dataset: readers, the generators and the reference-format
conversion (counterpart of ``galaxy_deconv_tpu/data/dataset.py``).

Layout on disk::

    <root>/info.json
    <root>/train/{obs,psf,gt,alpha,snr,gal_g1,gal_g2}.npy      (N, ...) arrays
    <root>/test/...                                  (random-SNR split)
    <root>/test/obs_{snr}.npy, gt_{snr}.npy          per fixed-SNR variant
    <root>/test/psf_shear_err_{e}.npy, psf_fwhm_err_{e}.npy

Batches are dicts of numpy arrays; ``alpha`` is recomputed per batch as the
mean of each obs stamp, as the reference does per sample.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
from typing import Iterator, Optional

import numpy as np
import torch

from galaxy_deconv_tpu_torch.data import simulate as sim
from galaxy_deconv_tpu_torch.utils.device import resolve_device

FIELDS = ("obs", "psf", "gt", "alpha", "snr", "gal_g1", "gal_g2")


@dataclasses.dataclass
class GalaxyDataset:
    """One split of a packed dataset, read through numpy memmaps.

    ``obs_variant`` (e.g. ``obs_100``) reads a fixed-SNR variant with its
    ``gt_100`` (or the split's ``gt`` where that is missing);
    ``psf_variant`` (e.g. ``psf_shear_err_0.02``) a perturbed-PSF set.
    """

    root: pathlib.Path
    split: str = "train"
    obs_variant: Optional[str] = None
    psf_variant: Optional[str] = None

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        with open(self.root / "info.json") as f:
            self.info = json.load(f)
        d = self.root / self.split
        self.obs = np.load(d / f"{self.obs_variant or 'obs'}.npy", mmap_mode="r")
        self.psf = np.load(d / f"{self.psf_variant or 'psf'}.npy", mmap_mode="r")
        gt_path = d / f"{'gt' if self.obs_variant is None else self.obs_variant.replace('obs', 'gt')}.npy"
        self.gt = np.load(gt_path if gt_path.exists() else d / "gt.npy", mmap_mode="r")
        self.gal_g1, self.gal_g2 = (np.load(d / f"{name}.npy", mmap_mode="r") for name in ("gal_g1", "gal_g2"))

    def __len__(self) -> int:
        return self.obs.shape[0]

    def batch(self, idx: np.ndarray) -> dict:
        obs = np.asarray(self.obs[idx], np.float32)
        return dict(
            obs=obs,
            psf=np.asarray(self.psf[idx], np.float32),
            gt=np.asarray(self.gt[idx], np.float32),
            alpha=obs.mean(axis=(-2, -1)),
            gal_g1=np.asarray(self.gal_g1[idx], np.float32),
            gal_g2=np.asarray(self.gal_g2[idx], np.float32),
        )


def iterate_batches(ds: GalaxyDataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                    drop_last: bool = True, indices: Optional[np.ndarray] = None, process_index: int = 0,
                    process_count: int = 1) -> Iterator[dict]:
    """Yield batch dicts over ``indices`` (default: all), shuffled by
    ``np.random.default_rng(seed)`` when ``shuffle``.

    As in the JAX reader, a numpy ``indices`` array is shuffled in place, so
    the epochs of ``fit`` compound their shuffles: the same batches as JAX's.
    With ``process_count`` > 1 this process reads the disjoint stride
    ``idx[process_index::process_count]`` of the (shuffled) indices, in
    batches of ``batch_size``, as the JAX reader splits them over hosts.
    """
    idx = np.arange(len(ds)) if indices is None else np.asarray(indices)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    idx = idx[process_index::process_count]
    n = len(idx)
    stop = n - (n % batch_size) if drop_last else n
    for s in range(0, stop, batch_size):
        yield ds.batch(idx[s : s + batch_size])


def train_val_indices(n: int, train_val_split: float = 0.8, seed: int = 0):
    """Random train/val index split (the reference's random_split)."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    n_train = int(train_val_split * n)
    return idx[:n_train], idx[n_train:]


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


SNRS = (20, 40, 60, 80, 100, 150, 200)  # the fixed-SNR test variants
PSF_ERRS = (0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.07, 0.1, 0.15, 0.2)  # the perturbed-PSF sets of each kind


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _chunk_seeds(seq: np.random.SeedSequence, total: int, chunk: int) -> list[tuple[int, int]]:
    """(seed, size) of each chunk of ``total`` samples, the seeds from ``seq``'s children."""
    sizes = [min(chunk, total - s) for s in range(0, total, chunk)]
    return [(int(c.generate_state(1, np.uint64)[0]), n) for c, n in zip(seq.spawn(len(sizes)), sizes)]


def chunk_plan(seed: int, n_train: int, n_test: int, chunk: int) -> tuple[list, list]:
    """The (seed, size) of every train chunk and of every test chunk that
    :func:`generate_dataset` renders for these arguments: the seeds of
    ``numpy.random.SeedSequence(seed)``'s two children's children."""
    train_seq, test_seq = np.random.SeedSequence(seed).spawn(2)
    return _chunk_seeds(train_seq, n_train, chunk), _chunk_seeds(test_seq, n_test, chunk)


def write_split(d: pathlib.Path, keys, cfg: sim.SimulationConfig, device, sampler=sim.simulate_batch,
                label: Optional[str] = None) -> None:
    """Render ``sampler``'s :data:`FIELDS` for each (seed, size) of ``keys``
    and write them stacked to ``d/<field>.npy`` (:func:`write_chunks`);
    progress under ``label``."""
    total = sum(n for _, n in keys)

    def chunks():
        done = 0
        for k, n in keys:
            out = sampler(k, n, cfg, device)
            yield {f: _np(out[f]) for f in FIELDS}
            done += n
            if label:
                print(f"\r{label} {done}/{total}", end="", flush=True)

    write_chunks(d, chunks(), total)
    if label:
        print()


def render_test_chunk(seed: int, n: int, cfg: sim.SimulationConfig, device, snrs=SNRS, shear_errs=PSF_ERRS,
                      fwhm_errs=PSF_ERRS) -> dict:
    """Every test array of one chunk: the random-SNR :data:`FIELDS`, each
    fixed-SNR variant's ``obs_{snr}`` and ``gt_{snr}`` (same scenes and noise,
    the flux scaled) and each perturbed-PSF set ``psf_{kind}_err_{e}`` (same
    scenes, one sign draw), all from ``seed``."""
    out = sim.simulate_batch(seed, n, cfg, device)
    blob = {f: _np(out[f]) for f in FIELDS}
    for snr in snrs:
        o = sim.simulate_batch_at_snr(seed, n, float(snr), cfg, device)
        blob[f"obs_{snr}"], blob[f"gt_{snr}"] = _np(o["obs"]), _np(o["gt"])
    for kind, errs in (("shear", shear_errs), ("fwhm", fwhm_errs)):
        for e in errs:
            blob[f"psf_{kind}_err_{e}"] = _np(sim.simulate_perturbed_psfs(seed, n, cfg, device=device,
                                                                          **{f"{kind}_err": float(e)}))
    return blob


def write_chunks(d: pathlib.Path, chunks, total: int) -> None:
    """Write each array of the chunk dicts ``chunks``, stacked along the first
    axis to ``total`` rows, to ``d/<name>.npy``: a ``.npy`` header, then each
    chunk's rows appended as it comes, one chunk in memory at a time (the
    bytes ``np.save`` of the stacked array writes)."""
    d.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        files = {}
        for blob in chunks:
            for name, a in blob.items():
                if name not in files:
                    files[name] = stack.enter_context(open(d / f"{name}.npy", "wb"))
                    np.lib.format.write_array_header_1_0(files[name], {
                        "descr": np.lib.format.dtype_to_descr(a.dtype), "fortran_order": False,
                        "shape": (total, *a.shape[1:])})
                np.ascontiguousarray(a).tofile(files[name])


def dataset_info(n_train: int, n_test: int, seed: int, cfg: sim.SimulationConfig, **task) -> dict:
    """A tree's ``info.json``: the sizes, the optics, the seed, ``task``'s
    entries (the variants, or the task's name) and the noise."""
    return dict(n_train=n_train, n_test=n_test, fov_pixels=cfg.fov_pixels, pixel_scale=cfg.pixel_scale,
                upsample=cfg.upsample, seed=seed, **task, noise_sigma=sim.noise_sigma(cfg.pixel_scale),
                generator="galaxy_deconv_tpu_torch.data.simulate")


def write_info(root: pathlib.Path, info: dict) -> None:
    with open(root / "info.json", "w") as f:
        json.dump(info, f, indent=1)


def generate_dataset(
    root,
    n_train: int = 2000,
    n_test: int = 500,
    cfg: sim.SimulationConfig = sim.SimulationConfig(),
    seed: int = 31415,
    chunk: int = 128,
    snrs=SNRS,
    shear_errs=PSF_ERRS,
    fwhm_errs=PSF_ERRS,
    verbose: bool = True,
    device="cuda",
) -> pathlib.Path:
    """Simulate on ``device`` and write a benchmark dataset: the train split,
    the random-SNR test split, a fixed-SNR test variant per ``snrs`` and the
    perturbed-PSF sets (the reference generate_data.py's layout).

    ``numpy.random.SeedSequence(seed)`` gives the train and the test split a
    child each, and those give one seed per chunk (:func:`chunk_plan`).
    Every test chunk's seed renders its random-SNR stamps, each fixed-SNR
    variant and each perturbed-PSF set (:func:`render_test_chunk`), so the
    variants hold the same galaxies; nothing of the train split comes from
    it.  The same seed on the same kind of device writes the same files (see
    :mod:`galaxy_deconv_tpu_torch.data.simulate` on the streams).
    """
    dev = resolve_device(device)
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    train_keys, test_keys = chunk_plan(seed, n_train, n_test, chunk)
    write_split(root / "train", train_keys, cfg, dev, label="train" if verbose else None)
    write_chunks(root / "test", (render_test_chunk(k, n, cfg, dev, snrs, shear_errs, fwhm_errs)
                                 for k, n in test_keys), n_test)
    if verbose:
        print(f"test split, {len(snrs)} SNR variants and {len(shear_errs) + len(fwhm_errs)} PSF sets done")
    write_info(root, dataset_info(n_train, n_test, seed, cfg, snrs=list(snrs), shear_errs=list(shear_errs),
                                  fwhm_errs=list(fwhm_errs)))
    return root


def generate_dataset_denoise(
    root,
    n_train: int = 2000,
    n_test: int = 500,
    cfg: sim.SimulationConfig = sim.SimulationConfig(),
    seed: int = 31415,
    chunk: int = 128,
    verbose: bool = True,
    device="cuda",
) -> pathlib.Path:
    """Simulate on ``device`` and write a denoising-task dataset (the
    reference's ``generate_data.py --task Denoise``): train and test splits
    of obs = gt + CCD noise, no PSF (``psf`` all zeros), the training set of
    the standalone ResUNet that ADMMNet runs frozen.  Seeds as in
    :func:`generate_dataset`: ``numpy.random.SeedSequence(seed)`` gives each
    split a child, and those give one seed per chunk."""
    dev = resolve_device(device)
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for split, keys in zip(("train", "test"), chunk_plan(seed, n_train, n_test, chunk)):
        write_split(root / split, keys, cfg, dev, sim.simulate_batch_denoise, label=split if verbose else None)
    write_info(root, dataset_info(n_train, n_test, seed, cfg, task="Denoise"))
    return root


def load_reference_pth_dataset(data_path, out_root, train: bool = True, limit: Optional[int] = None) -> pathlib.Path:
    """Convert the reference's per-sample ``.pth`` layout
    (``{obs,psf,gt}/{k}_{i}.pth`` and an ``info.json`` with ``n_train`` and
    ``n_test``, the test samples numbered after the train ones) into packed
    arrays under ``out_root``; alpha is each obs stamp's mean, and snr and
    the true shear, which that layout does not hold, are zeros."""
    data_path, out_root = pathlib.Path(data_path), pathlib.Path(out_root)
    with open(data_path / "info.json") as f:
        info = json.load(f)
    n_train, n_test = info["n_train"], info["n_test"]
    start, count = (0, n_train) if train else (n_train, n_test)
    if limit:
        count = min(count, limit)

    fields = {k: np.stack([torch.load(data_path / k / f"{k}_{i}.pth", map_location="cpu", weights_only=True).numpy()
                           for i in range(start, start + count)]).astype(np.float32)
              for k in ("obs", "psf", "gt")}
    d = out_root / ("train" if train else "test")
    d.mkdir(parents=True, exist_ok=True)
    for k, v in fields.items():
        np.save(d / f"{k}.npy", v)
    np.save(d / "alpha.npy", fields["obs"].mean(axis=(-2, -1)).astype(np.float32))
    for k in ("snr", "gal_g1", "gal_g2"):
        np.save(d / f"{k}.npy", np.zeros(count, np.float32))
    with open(out_root / "info.json", "w") as f:
        json.dump({**info, "converted_from": str(data_path)}, f)
    return out_root
