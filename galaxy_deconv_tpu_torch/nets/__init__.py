"""The nets of the solvers, NCHW ``nn.Module``s: the ResUNet denoiser, the
SubNet penalty-schedule network and the XDenseUNet."""

from galaxy_deconv_tpu_torch.nets.blocks import (BatchNorm2d, DoubleConv, DownConv, ResBlock, SeparableConv,
                                                 UpConvTranspose)
from galaxy_deconv_tpu_torch.nets.resunet import ResUNet
from galaxy_deconv_tpu_torch.nets.subnet import SubNet, psf_power_spectrum
from galaxy_deconv_tpu_torch.nets.xdense_unet import XDenseUNet

__all__ = ["BatchNorm2d", "DoubleConv", "DownConv", "ResBlock", "ResUNet", "SeparableConv", "SubNet",
           "UpConvTranspose", "XDenseUNet", "psf_power_spectrum"]
