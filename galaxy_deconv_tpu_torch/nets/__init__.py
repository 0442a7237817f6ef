"""ResUNet denoiser and SubNet penalty-schedule network, NCHW ``nn.Module``s."""

from galaxy_deconv_tpu_torch.nets.blocks import BatchNorm2d, DoubleConv, DownConv, ResBlock, UpConvTranspose
from galaxy_deconv_tpu_torch.nets.resunet import ResUNet
from galaxy_deconv_tpu_torch.nets.subnet import SubNet, psf_power_spectrum

__all__ = ["BatchNorm2d", "DoubleConv", "DownConv", "ResBlock", "ResUNet", "SubNet", "UpConvTranspose",
           "psf_power_spectrum"]
