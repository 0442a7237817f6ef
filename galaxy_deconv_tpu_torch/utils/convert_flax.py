"""Weight bridge: the JAX package's flax variables -> this package's state_dict.

Takes ``params`` and ``batch_stats`` as nested dicts of numpy arrays (as a
restored orbax checkpoint gives them after ``np.asarray``) and needs nothing
of JAX.  It inverts the layout maps of ``galaxy_deconv_tpu/utils/convert_torch.py``:

    Conv            HWIO                     -> OIHW
    ConvTranspose   (kh, kw, I, O), flipped  -> (I, O, kh, kw)
    Dense           (in, out)                -> (out, in)
    BatchNorm       scale/bias + mean/var    -> weight/bias + running_mean/var

flax's ConvTranspose is a fractionally strided convolution, so its taps are
torch's ConvTranspose2d taps flipped in space.  SubNet's first Dense needs no
column permutation: this package's SubNet flattens in flax's HWC order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def conv_weight(k) -> np.ndarray:
    """flax HWIO -> torch OIHW."""
    return np.asarray(k).transpose(3, 2, 0, 1)


def conv_transpose_weight(k) -> np.ndarray:
    """flax ConvTranspose (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw), flipped."""
    return np.asarray(k).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def dense_weight(k) -> np.ndarray:
    """flax (in, out) -> torch (out, in)."""
    return np.asarray(k).T


def _batch_norm(p: Mapping, s: Mapping, key: str) -> dict:
    return {
        f"{key}.weight": p["scale"],
        f"{key}.bias": p["bias"],
        f"{key}.running_mean": s["mean"],
        f"{key}.running_var": s["var"],
    }


def resunet_state_dict(p: Mapping, prefix: str = "") -> dict:
    """flax ResUNet params -> ResUNet state_dict entries (numpy)."""
    sd = {f"{prefix}head.weight": conv_weight(p["Conv_0"]["kernel"]),
          f"{prefix}tail.weight": conv_weight(p["Conv_1"]["kernel"])}
    for name, sub in p.items():
        kind, _, k = name.rpartition("_")
        if kind == "ResBlock":
            sd[f"{prefix}resblocks.{k}.conv0.weight"] = conv_weight(sub["Conv_0"]["kernel"])
            sd[f"{prefix}resblocks.{k}.conv1.weight"] = conv_weight(sub["Conv_1"]["kernel"])
        elif kind == "DownConv":
            sd[f"{prefix}downs.{k}.weight"] = conv_weight(sub["Conv_0"]["kernel"])
        elif kind == "UpConvTranspose":
            sd[f"{prefix}ups.{k}.weight"] = conv_transpose_weight(sub["ConvTranspose_0"]["kernel"])
        elif name not in ("Conv_0", "Conv_1"):
            raise KeyError(f"unexpected ResUNet parameter group {name!r}")
    return sd


def subnet_state_dict(p: Mapping, s: Mapping, prefix: str = "") -> dict:
    """flax SubNet params/batch_stats -> SubNet state_dict entries (numpy)."""
    sd: dict = {}
    for name, sub in p.items():
        kind, _, k = name.rpartition("_")
        if kind == "DoubleConv":
            base = f"{prefix}convs.{k}"
            for j in (0, 1):
                sd[f"{base}.conv{j}.weight"] = conv_weight(sub[f"Conv_{j}"]["kernel"])
                sd[f"{base}.conv{j}.bias"] = sub[f"Conv_{j}"]["bias"]
                sd.update(_batch_norm(sub[f"BatchNorm_{j}"], s[name][f"BatchNorm_{j}"], f"{base}.bn{j}"))
                sd[f"{base}.bn{j}.num_batches_tracked"] = np.zeros((), np.int64)
        elif kind == "Dense":
            sd[f"{prefix}dense.{k}.weight"] = dense_weight(sub["kernel"])
            sd[f"{prefix}dense.{k}.bias"] = sub["bias"]
        else:
            raise KeyError(f"unexpected SubNet parameter group {name!r}")
    return sd


def unrolled_admm_gaussian_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """flax variables of ``UnrolledADMMGaussian`` -> this package's state_dict.

    ``params`` holds ``ResUNet_0`` and either ``SubNet_0`` (with its BN
    statistics under ``batch_stats``) or ``rho_iters``.
    """
    sd: dict = {}
    for name, sub in params.items():
        if name == "ResUNet_0":
            sd.update(resunet_state_dict(sub, "resunet."))
        elif name == "SubNet_0":
            sd.update(subnet_state_dict(sub, (batch_stats or {})["SubNet_0"], "subnet."))
        elif name == "rho_iters":
            sd["rho_iters"] = sub
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
