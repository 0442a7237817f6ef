"""FLOP and byte counts of a forward, for the MFU/roofline report
(``bench.py::mfu_report``, ``scripts/mfu_torch.py``), and the H100's peaks.

:func:`measure` runs ``fn(*args)`` once and counts it three ways:

- ``flops``: torch's ``FlopCounterMode``, which counts the aten convolutions
  (transposed ones too) and matmuls, 2 FLOPs a multiply-add, and nothing
  else: no FFT, no elementwise op, no custom kernel;
- ``layer_flops``: the same work from the layers' shapes alone, by the
  qualified name of each of ``model``'s ``Conv2d`` (2 * C_in/groups * C_out *
  k_h * k_w * H_out * W_out a call), ``ConvTranspose2d`` (2 * C_in *
  C_out/groups * k_h * k_w * H_in * W_in: each input pixel scatters a k x k
  patch) and ``Linear`` (2 * in * out a row) modules, summed over the calls
  that forward hooks see;
- ``bytes``: every aten op's tensor inputs and outputs (views and
  allocations excluded), and the operands of each x-update solve kernel
  launch (``ops/x_update.py`` counts them): the traffic if no two ops fused,
  an upper bound of what the device moves (XLA's unfused "bytes accessed").
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from galaxy_deconv_tpu_torch.ops import x_update as xu

# NVIDIA H100 SXM published peaks (data sheet, 700 W): dense bf16 on the tensor
# cores, float32 outside them (the port's float32 runs with TF32 off), HBM3.
H100_PEAK_BF16 = 989.4e12  # FLOP/s
H100_PEAK_FP32 = 67e12  # FLOP/s
H100_HBM_BW = 3.35e12  # bytes/s

# ops that only allocate: they move no bytes (a fill such as zeros writes its output and counts)
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@dataclass
class Counts:
    """What :func:`measure` counted in one call (see the module docstring)."""

    flops: int
    flops_by_op: dict
    layer_flops: dict
    bytes: int

    @property
    def analytic_flops(self) -> int:
        return sum(self.layer_flops.values())

    def analytic_flops_in(self, prefix: str) -> int:
        """The layers' count within the submodule named ``prefix`` (all its calls)."""
        return sum(n for name, n in self.layer_flops.items() if name.startswith(prefix + "."))


def _layer_flops(mod: nn.Module, x: torch.Tensor, y: torch.Tensor) -> int:
    if isinstance(mod, nn.ConvTranspose2d):
        c_in, c_out_g, kh, kw = mod.weight.shape
        return 2 * x.shape[0] * c_in * c_out_g * kh * kw * x.shape[-2] * x.shape[-1]
    if isinstance(mod, nn.Conv2d):
        c_out, c_in_g, kh, kw = mod.weight.shape
        return 2 * y.shape[0] * c_in_g * c_out * kh * kw * y.shape[-2] * y.shape[-1]
    return 2 * mod.in_features * mod.out_features * math.prod(x.shape[:-1])  # Linear


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func._schema.name.split("::")[-1] in _ALLOCATIONS):
            self.bytes += sum(t.numel() * t.element_size() for t in tree_flatten((args, kwargs, out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def measure(model: nn.Module, fn, *args) -> Counts:
    """Count one call of ``fn(*args)``, whose layers are ``model``'s (see the module docstring)."""
    layer_flops: dict = {}

    def hook(name):
        def count(mod, inputs, output):
            layer_flops[name] = layer_flops.get(name, 0) + _layer_flops(mod, inputs[0], output)
        return count

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    kernel_bytes = xu.x_update_solve.launched_bytes
    try:
        # the byte counter on top sees each op as it would run uncounted: FlopCounterMode decomposes the ops
        # it has no formula for, and beneath it the byte counter would see the pieces
        with FlopCounterMode(display=False) as flop_counter, _ByteCounter() as counter:
            fn(*args)
    finally:
        for h in handles:
            h.remove()
    by_op = {str(op): int(n) for op, n in flop_counter.get_flop_counts()["Global"].items()}
    return Counts(flop_counter.get_total_flops(), by_op, layer_flops,
                  counter.bytes + xu.x_update_solve.launched_bytes - kernel_bytes)
