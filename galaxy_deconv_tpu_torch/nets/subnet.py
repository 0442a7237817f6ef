"""SubNet, the ADMM penalty-schedule network (counterpart of
``galaxy_deconv_tpu/nets/subnet.py:28-69``).

The PSF is embedded in a 128x128 canvas, its power spectrum |FFT|^2 goes
through 4 x [maxpool 2 + DoubleConv] down to 16 x 8 x 8, the photon level
alpha is appended, and a 3-layer MLP with Softplus (+1e-6) gives
``n_outputs`` positive penalties per galaxy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from galaxy_deconv_tpu_torch.nets.blocks import DoubleConv
from galaxy_deconv_tpu_torch.ops import fourier

_WIDTHS = (4, 8, 16, 16)


def psf_power_spectrum(psf: torch.Tensor, size: int = 128) -> torch.Tensor:
    """|FFT|^2 of the PSF embedded centred in a ``size`` x ``size`` canvas.

    psf: (B, h, w) -> (B, size, size) float32.
    """
    k_pad = fourier.pad_to_size_centered(psf.float(), (size, size))
    return torch.fft.fft2(fourier.ifftshift2(k_pad), dim=(-2, -1)).abs() ** 2


class SubNet(nn.Module):
    """PSF power spectrum + alpha -> (B, n_outputs) positive scalars.

    ``raw=True`` returns the pre-Softplus logits (the bounded-rho path).
    Its convolutions and dense layers compute in ``dtype`` (BatchNorm in
    float32, see :class:`DoubleConv`); it returns float32.
    """

    def __init__(self, n_outputs: int, spectrum_size: int = 128, raw: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spectrum_size = spectrum_size
        self.raw = raw
        widths = (1, *_WIDTHS)
        self.convs = nn.ModuleList(DoubleConv(widths[i], widths[i + 1], dtype) for i in range(len(_WIDTHS)))
        n_flat = _WIDTHS[-1] * (spectrum_size // 2 ** len(_WIDTHS)) ** 2
        self.dense = nn.ModuleList([nn.Linear(n_flat + 1, 64, dtype=dtype), nn.Linear(64, 64, dtype=dtype),
                                    nn.Linear(64, n_outputs, dtype=dtype)])

    def forward(self, psf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        B = psf.shape[0]
        dtype = self.dense[0].weight.dtype
        alpha = alpha.reshape(B).to(dtype)
        x = psf_power_spectrum(psf, self.spectrum_size)[:, None].to(dtype)
        for conv in self.convs:
            x = conv(F.max_pool2d(x, 2))
        # flax flattens NHWC in HWC order; its first Dense kernel expects that
        x = x.permute(0, 2, 3, 1).reshape(B, -1)
        x = torch.cat([x, alpha[:, None]], dim=-1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        x = self.dense[2](x)
        if self.raw:
            return x.float()
        return F.softplus(x).float() + 1e-6
