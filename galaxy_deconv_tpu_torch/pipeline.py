"""The flagship inference pipeline: UnrolledADMMGaussian, then estimate_shear.

The counterpart of the pipeline that ``bench.py`` times: (B, 48, 48) obs and
psf stamps and per-galaxy alpha in, (B, 3) shear estimates (g1, g2, |g|) out.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
from torch import nn

from galaxy_deconv_tpu_torch.metrics.shear import estimate_shear
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.utils.device import fp32_only, resolve_device

# the standard deviation of N(0, 1) truncated to [-2, 2], as flax's variance_scaling divides by it
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_parameters(model: nn.Module, seed: int) -> None:
    """Fill ``model`` from a CPU ``torch.Generator`` seeded with ``seed``, as
    flax initialises: weights from flax's default ``lecun_normal``, a normal
    truncated at two standard deviations and scaled to variance 1/fan_in (so
    |w| * sqrt(fan_in) <= 2 / 0.8796...); biases 0, BatchNorm identity,
    rho_iters 1.  The same seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                # fan_in of the flax kernel: inputs x taps (torch keeps
                # ConvTranspose2d weights as (in, out, kh, kw))
                fan_in = w.shape[0 if isinstance(mod, nn.ConvTranspose2d) else 1] * math.prod(w.shape[2:])
                std = 1.0 / (math.sqrt(fan_in) * _TRUNCATED_NORMAL_STD)
                draw = torch.empty(w.shape)
                nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
                w.copy_(draw)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        if getattr(model, "rho_iters", None) is not None:
            model.rho_iters.fill_(1.0)


class Pipeline:
    """``pipeline(obs, psf, alpha) -> (B, 3)``; see :func:`build_pipeline`."""

    def __init__(self, model: UnrolledADMMGaussian, device: torch.device):
        self.model = model
        self.device = device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def reconstruct(self, obs, psf, alpha) -> torch.Tensor:
        """(B, H, W) reconstructions on the pipeline's device."""
        obs = self._tensor(obs)
        with fp32_only():  # fp32 nets run in fp32, not TF32; the spectra are fp32 whatever the nets' type
            return self.model(obs, self._tensor(psf), self._tensor(alpha).reshape(obs.shape[0]))

    @torch.inference_mode()
    def __call__(self, obs, psf, alpha) -> torch.Tensor:
        return estimate_shear(self.reconstruct(obs, psf, alpha))


def build_pipeline(device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32, seed: int = 0,
                   state_dict: Mapping[str, torch.Tensor] | None = None, *, n_iters: int = 8,
                   features: Sequence[int] = (32, 64, 128, 256), fft_impl: str = "auto") -> Pipeline:
    """The flagship UnrolledADMMGaussian(n_iters) + shear pipeline on ``device``.

    Weights come from ``state_dict`` (e.g. the bridge's output for a trained
    checkpoint) or, without one, from ``seed``.  ``dtype`` is the ResUNet's
    and SubNet's compute type; the spectra stay float32.  Every call runs
    with TF32 off (:func:`~galaxy_deconv_tpu_torch.utils.device.fp32_only`),
    whatever the caller's flags, and restores them after.  Raises if
    ``device`` is CUDA and no card is present.
    """
    dev = resolve_device(device)
    model = UnrolledADMMGaussian(n_iters=n_iters, features=features, dtype=dtype, fft_impl=fft_impl)
    if state_dict is None:
        init_parameters(model, seed)
    else:
        model.load_state_dict(state_dict)
    return Pipeline(model.to(dev).eval(), dev)
