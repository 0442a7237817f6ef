"""XDenseUNet, Tikhonet's post-deconvolution network (counterpart of
``galaxy_deconv_tpu/nets/xdense_unet.py:27-91``), NCHW.

A DenseNet-style UNet on 48x48 stamps: dense blocks of BN -> ReLU ->
separable conv (growth 12), each layer's new features concatenated *before*
its input, ``[h, y]``, and the skip variant prepending the block's input,
``[x, y]``; downs BN -> ReLU -> 1x1 conv -> maxpool 2; ups 1x1 conv (with
bias) -> nearest upsample 2; the decoder concatenates ``[skip, up]``.  The
channel order is what lets flax's weights line up.  Widths: 112/220/352
encoder, 296 -> 84, 508 -> 72, 352 -> 60 decoder, 220 -> 1 head.

Convolutions compute in ``dtype``; BatchNorm keeps float32 statistics and
parameters (:class:`~galaxy_deconv_tpu_torch.nets.blocks.BatchNorm2d`).
``model.train()`` is the JAX module's ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from galaxy_deconv_tpu_torch.nets.blocks import BatchNorm2d, SeparableConv
from galaxy_deconv_tpu_torch.ops.resize import upsample_nearest


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)  # flax momentum 0.9


class DenseBlock(nn.Module):
    def __init__(self, in_features: int, num_layers: int, growth_rate: int = 12, skip_connection: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_features + k * growth_rate for k in range(num_layers)]
        self.norms = nn.ModuleList(_bn(w) for w in widths)
        self.convs = nn.ModuleList(SeparableConv(w, growth_rate, dtype=dtype) for w in widths)
        self.skip_connection = skip_connection
        self.out_features = in_features * (2 if skip_connection else 1) + num_layers * growth_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for norm, conv in zip(self.norms, self.convs):
            y = torch.cat([conv(F.relu(norm(y))), y], dim=1)
        return torch.cat([x, y], dim=1) if self.skip_connection else y


class Down(nn.Module):
    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = _bn(in_features)
        self.conv = nn.Conv2d(in_features, features, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(self.conv(F.relu(self.norm(x))), 2)


class Up(nn.Module):
    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(self.conv(x), 2)


class XDenseUNet(nn.Module):
    """(B, 1, H, W) -> (B, 1, H, W), H and W multiples of 8.

    flax's ``DenseBlock_k``, ``Down_k``, ``Up_k`` are ``blocks[k]``,
    ``downs[k]``, ``ups[k]``; its ``Conv_0``/``Conv_1`` are ``head``/``tail``.
    """

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = nn.Conv2d(1, 32, 3, padding=1, bias=False, dtype=dtype)
        blocks, downs, ups = [], [], []
        width = 32
        skips = []
        # encoder: dense block (with skip) then down, three times
        for layers, down in ((4, 80), (5, 140), (6, 212)):
            blocks.append(DenseBlock(width, layers, skip_connection=True, dtype=dtype))
            skips.append(blocks[-1].out_features)
            downs.append(Down(skips[-1], down, dtype=dtype))
            width = down
        # body, then decoder: dense block then up, the up's output joined to the skip
        for layers, up in ((7, 84), (6, 72), (5, 60)):
            blocks.append(DenseBlock(width, layers, dtype=dtype))
            ups.append(Up(blocks[-1].out_features, up, dtype=dtype))
            width = skips.pop() + up
        blocks.append(DenseBlock(width, 4, dtype=dtype))
        self.blocks, self.downs, self.ups = nn.ModuleList(blocks), nn.ModuleList(downs), nn.ModuleList(ups)
        self.tail = nn.Conv2d(blocks[-1].out_features, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.head.weight.dtype))
        skips = []
        for k in range(3):
            skips.append(self.blocks[k](x))
            x = self.downs[k](skips[-1])
        for k in range(3):
            x = torch.cat([skips.pop(), self.ups[k](self.blocks[3 + k](x))], dim=1)
        return self.tail(self.blocks[6](x))
