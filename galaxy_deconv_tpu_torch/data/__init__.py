"""Packed-dataset readers."""

from galaxy_deconv_tpu_torch.data.dataset import FIELDS, GalaxyDataset, iterate_batches, train_val_indices

__all__ = ["FIELDS", "GalaxyDataset", "iterate_batches", "train_val_indices"]
