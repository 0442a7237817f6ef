"""Run configuration of the ``train`` and ``test`` commands (counterpart of
``galaxy_deconv_tpu/config.py:18-80``).

The flags keep the reference's vocabulary (--model, --n_iters, --loss,
--train_val_split, --batch_size, --pretrained_epochs, --test, --snrs, ...);
``--device`` picks the device (the card unless ``cpu``) and ``--fft_impl``
takes the port's names.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from galaxy_deconv_tpu_torch.models.unrolled_admm_gaussian import FFT_IMPLS


@dataclasses.dataclass
class RunConfig:
    # model
    model: str = "Unrolled_ADMM"
    n_iters: int = 8
    llh: str = "Gaussian"
    filter: str = "Laplacian"
    remove_subnet: bool = False
    fft_impl: str = "auto"
    # training
    loss: str = "MultiScale"
    n_epochs: int = 50
    lr: float = 2e-4
    train_val_split: float = 0.9
    batch_size: int = 32
    pretrained_epochs: int = 0
    # data / io
    data_path: str = "datasets/LSST_23.5_deconv_tpu"
    model_save_path: str = "saved_models"
    result_path: str = "results"
    # evaluation
    test: str = "shear"
    n_gal: int = 10000
    snrs: Sequence[int] = (20, 40, 60, 80, 100, 150, 200)
    eval_batch_size: int = 512
    n_devices: Optional[int] = None  # the devices of the data mesh, one process each; None: every rank
    seed: int = 42
    device: str = "cuda"


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = RunConfig()
    parser.add_argument("--model", type=str, default=d.model,
                        choices=["Unrolled_ADMM", "Tikhonet", "ShapeNet", "ResUNet"])
    parser.add_argument("--n_iters", type=int, default=d.n_iters)
    parser.add_argument("--llh", type=str, default=d.llh, choices=["Gaussian", "Poisson"])
    parser.add_argument("--filter", type=str, default=d.filter, choices=["Identity", "Laplacian"])
    parser.add_argument("--remove_SubNet", dest="remove_subnet", action="store_true")
    parser.add_argument("--fft_impl", type=str, default=d.fft_impl, choices=list(FFT_IMPLS))
    parser.add_argument("--loss", type=str, default=d.loss,
                        choices=["MultiScale", "MSE", "Shape", "BestEllipse", "MomentBasedLoss"])
    parser.add_argument("--n_epochs", type=int, default=d.n_epochs)
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--train_val_split", type=float, default=d.train_val_split)
    parser.add_argument("--batch_size", type=int, default=d.batch_size)
    parser.add_argument("--pretrained_epochs", type=int, default=d.pretrained_epochs)
    parser.add_argument("--data_path", type=str, default=d.data_path)
    parser.add_argument("--model_save_path", type=str, default=d.model_save_path)
    parser.add_argument("--result_path", type=str, default=d.result_path)
    parser.add_argument("--test", type=str, default=d.test, choices=["shear", "time", "psf_shear", "psf_fwhm"])
    parser.add_argument("--n_gal", type=int, default=d.n_gal)
    parser.add_argument("--snrs", type=int, nargs="+", default=list(d.snrs))
    parser.add_argument("--n_devices", type=int, default=None,
                        help="devices of the data mesh, one process each (torchrun --nproc_per_node N); "
                             "must equal the world size; unset: every rank")
    parser.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--device", type=str, default=d.device, help="cuda (default) or cpu")
    return parser


def from_namespace(ns: argparse.Namespace) -> RunConfig:
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in vars(ns).items() if k in fields})
