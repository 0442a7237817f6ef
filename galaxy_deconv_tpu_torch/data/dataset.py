"""Readers of the packed dataset (counterpart of ``galaxy_deconv_tpu/data/dataset.py:38-108``).

Its own copy, numpy only: the JAX module imports jax and the simulator.
Layout on disk::

    <root>/info.json
    <root>/train/{obs,psf,gt,alpha,snr,gal_g1,gal_g2}.npy      (N, ...) arrays

Batches are dicts of numpy arrays; ``alpha`` is recomputed per batch as the
mean of each obs stamp, as the reference does per sample.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterator, Optional

import numpy as np

FIELDS = ("obs", "psf", "gt", "alpha", "snr", "gal_g1", "gal_g2")


@dataclasses.dataclass
class GalaxyDataset:
    """One split of a packed dataset, read through numpy memmaps."""

    root: pathlib.Path
    split: str = "train"

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        with open(self.root / "info.json") as f:
            self.info = json.load(f)
        d = self.root / self.split
        self.obs, self.psf, self.gt, self.gal_g1, self.gal_g2 = (
            np.load(d / f"{name}.npy", mmap_mode="r") for name in ("obs", "psf", "gt", "gal_g1", "gal_g2"))

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
                    drop_last: bool = True, indices: Optional[np.ndarray] = None) -> Iterator[dict]:
    """Yield batch dicts over ``indices`` (default: all), shuffled by
    ``np.random.default_rng(seed)`` when ``shuffle``.

    As in the JAX reader, a numpy ``indices`` array is shuffled in place, so
    the epochs of ``fit`` compound their shuffles: the same batches as JAX's.
    """
    idx = np.arange(len(ds)) if indices is None else np.asarray(indices)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
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
