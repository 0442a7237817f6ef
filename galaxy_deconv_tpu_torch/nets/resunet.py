"""ResUNet denoiser, the PnP-ADMM z-update (counterpart of
``galaxy_deconv_tpu/nets/resunet.py:25-60``).

A 4-scale residual UNet: head conv; three [ResBlocks + stride-2 down]
stages; ResBlock body; three [transposed-conv up + ResBlocks] stages with
*additive* skips; tail conv.  No normalisation, all convolutions bias-free.
Inputs are edge-padded to a multiple of 8 and cropped back.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from galaxy_deconv_tpu_torch.nets.blocks import DownConv, ResBlock, UpConvTranspose
from galaxy_deconv_tpu_torch.ops.resize import pad_to_multiple_edge


class ResUNet(nn.Module):
    """(B, C_in, H, W) -> (B, C_out, H, W).

    ``resblocks`` holds the residual blocks in call order, ``num_blocks`` per
    stage over the seven stages (three down, body, three up), so flax's
    ``ResBlock_k`` is ``resblocks[k]``.
    """

    def __init__(self, features: Sequence[int] = (64, 128, 256, 512), num_blocks: int = 2,
                 in_features: int = 1, out_features: int = 1):
        super().__init__()
        f = tuple(features)
        self.num_blocks = num_blocks
        self.head = nn.Conv2d(in_features, f[0], 3, padding=1, bias=False)
        stage_widths = (f[0], f[1], f[2], f[3], f[2], f[1], f[0])
        self.resblocks = nn.ModuleList(ResBlock(w) for w in stage_widths for _ in range(num_blocks))
        self.downs = nn.ModuleList(DownConv(f[i], f[i + 1]) for i in range(3))
        self.ups = nn.ModuleList(UpConvTranspose(f[3 - i], f[2 - i]) for i in range(3))
        self.tail = nn.Conv2d(f[0], out_features, 3, padding=1, bias=False)

    def _stage(self, z: torch.Tensor, s: int) -> torch.Tensor:
        for block in self.resblocks[s * self.num_blocks : (s + 1) * self.num_blocks]:
            z = block(z)
        return z

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, (h, w) = pad_to_multiple_edge(x, multiple=8)
        x1 = self.head(x)
        x2 = self.downs[0](self._stage(x1, 0))
        x3 = self.downs[1](self._stage(x2, 1))
        x4 = self.downs[2](self._stage(x3, 2))
        z = self._stage(x4, 3)
        z = self._stage(self.ups[0](z + x4), 4)
        z = self._stage(self.ups[1](z + x3), 5)
        z = self._stage(self.ups[2](z + x2), 6)
        return self.tail(z + x1)[..., :h, :w]
