"""The standalone denoiser (counterpart of
``galaxy_deconv_tpu/models/denoiser.py``; the reference's ``--model
ResUNet``): a ResUNet trained on the denoising task (obs = gt + noise) under
the solvers' ``(obs, psf, alpha) -> rec`` contract, ``psf`` and ``alpha``
ignored.  Its weights are the denoiser that :class:`ADMMNet` runs frozen:
both keep them under ``resunet.``, so one state_dict serves both.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from galaxy_deconv_tpu_torch.nets import ResUNet


class ResUNetDenoiser(nn.Module):
    def __init__(self, features: Sequence[int] = (64, 128, 256, 512), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resunet = ResUNet(features=features).to(dtype)

    def forward(self, obs: torch.Tensor, psf: torch.Tensor = None, alpha: torch.Tensor = None) -> torch.Tensor:
        return self.resunet(obs[:, None].to(self.dtype))[:, 0].float()
