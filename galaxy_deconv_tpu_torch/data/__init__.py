"""Packed-dataset readers and generators, and the simulator."""

from galaxy_deconv_tpu_torch.data.dataset import (FIELDS, GalaxyDataset, generate_dataset, generate_dataset_denoise,
                                                  iterate_batches, load_reference_pth_dataset, train_val_indices)
from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig, noise_sigma

__all__ = ["FIELDS", "GalaxyDataset", "SimulationConfig", "generate_dataset", "generate_dataset_denoise",
           "iterate_batches", "load_reference_pth_dataset", "noise_sigma", "train_val_indices"]
