"""Packed-dataset readers and generator, and the simulator."""

from galaxy_deconv_tpu_torch.data.dataset import (FIELDS, GalaxyDataset, generate_dataset, iterate_batches,
                                                  train_val_indices)
from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig, noise_sigma

__all__ = ["FIELDS", "GalaxyDataset", "SimulationConfig", "generate_dataset", "iterate_batches", "noise_sigma",
           "train_val_indices"]
