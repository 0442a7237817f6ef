"""Weight bridge: the JAX package's flax variables -> this package's state_dict.

Takes ``params`` and ``batch_stats`` as nested dicts of numpy arrays (as a
restored orbax checkpoint gives them after ``np.asarray``) and needs nothing
of JAX.  It inverts the layout maps of ``galaxy_deconv_tpu/utils/convert_torch.py``:

    Conv            HWIO                     -> OIHW
    ConvTranspose   (kh, kw, I, O), flipped  -> (I, O, kh, kw)
    Dense           (in, out)                -> (out, in)
    BatchNorm       scale/bias + mean/var    -> weight/bias + running_mean/var

flax's ConvTranspose is a fractionally strided convolution, so its taps are
torch's ConvTranspose2d taps flipped in space; a depthwise Conv's
(kh, kw, 1, C) kernel is torch's (C, 1, kh, kw) by the same HWIO -> OIHW map.
SubNet's first Dense needs no column permutation: this package's SubNet
flattens in flax's HWC order.

Every solver of the zoo names its nets the same way in both packages, so one
map serves them all (:func:`model_state_dict`): ``ResUNet_0`` -> ``resunet.``,
``SubNet_0`` -> ``subnet.``, ``XDenseUNet_0`` -> ``xdense_unet.``, and the
learnt scalars (``rho_iters``, ``rho1_iters``, ``rho2_iters``, ``lam_raw``)
keep their names.  An ADMMNet takes a trained ``ResUNet`` checkpoint's
``ResUNet_0`` as it is.

The train state crosses too: optax's ``ScaleByAdamState`` moments ``mu`` and
``nu`` have the parameters' tree and layouts, so the same maps carry them
across element for element (:func:`train_state_payload`).  Under
``optax.multi_transform`` a frozen parameter's moment is an empty
``MaskedNode``; it has no counterpart and is dropped.
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


def _batch_norm(p: Mapping, s: Mapping | None, key: str) -> dict:
    sd = {f"{key}.weight": p["scale"], f"{key}.bias": p["bias"]}
    if s is not None:
        sd.update({f"{key}.running_mean": s["mean"], f"{key}.running_var": s["var"],
                   f"{key}.num_batches_tracked": np.zeros((), np.int64)})
    return sd


def _items(p: Mapping, convs: Mapping[str, str], prefix: str) -> dict:
    """Bias-free convolutions: the entries of ``p`` whose flax name ``convs``
    maps to a torch module name."""
    return {f"{prefix}{convs[k]}.weight": conv_weight(v["kernel"]) for k, v in p.items() if k in convs}


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


def subnet_state_dict(p: Mapping, s: Mapping | None, prefix: str = "") -> dict:
    """flax SubNet params/batch_stats -> SubNet state_dict entries (numpy);
    parameters only when ``s`` is None."""
    sd: dict = {}
    for name, sub in p.items():
        kind, _, k = name.rpartition("_")
        if kind == "DoubleConv":
            base = f"{prefix}convs.{k}"
            for j in (0, 1):
                sd[f"{base}.conv{j}.weight"] = conv_weight(sub[f"Conv_{j}"]["kernel"])
                sd[f"{base}.conv{j}.bias"] = sub[f"Conv_{j}"]["bias"]
                stats = None if s is None else s[name][f"BatchNorm_{j}"]
                sd.update(_batch_norm(sub[f"BatchNorm_{j}"], stats, f"{base}.bn{j}"))
        elif kind == "Dense":
            sd[f"{prefix}dense.{k}.weight"] = dense_weight(sub["kernel"])
            sd[f"{prefix}dense.{k}.bias"] = sub["bias"]
        else:
            raise KeyError(f"unexpected SubNet parameter group {name!r}")
    return sd


def xdense_unet_state_dict(p: Mapping, s: Mapping | None, prefix: str = "") -> dict:
    """flax XDenseUNet params/batch_stats -> XDenseUNet state_dict entries
    (numpy); parameters only when ``s`` is None."""
    sd: dict = {}

    def bn(sub: Mapping, group: str, layer: str, key: str):
        sd.update(_batch_norm(sub, None if s is None else s[group][layer], key))

    for name, sub in p.items():
        kind, _, k = name.rpartition("_")
        if name in ("Conv_0", "Conv_1"):
            key = f"{prefix}{'head' if name == 'Conv_0' else 'tail'}"
            sd[f"{key}.weight"] = conv_weight(sub["kernel"])
            if "bias" in sub:
                sd[f"{key}.bias"] = sub["bias"]
        elif kind == "DenseBlock":
            base = f"{prefix}blocks.{k}."
            for layer, leaf in sub.items():
                lkind, _, j = layer.rpartition("_")
                if lkind == "BatchNorm":
                    bn(leaf, name, layer, f"{base}norms.{j}")
                elif lkind == "SeparableConv":
                    sd.update(_items(leaf, {"Conv_0": f"convs.{j}.depthwise", "Conv_1": f"convs.{j}.pointwise"},
                                     base))
                else:
                    raise KeyError(f"unexpected DenseBlock parameter group {layer!r}")
        elif kind in ("Down", "Up"):
            base = f"{prefix}{kind.lower()}s.{k}."
            sd.update(_items(sub, {"Conv_0": "conv"}, base))
            if "bias" in sub.get("Conv_0", {}):
                sd[f"{base}conv.bias"] = sub["Conv_0"]["bias"]
            if "BatchNorm_0" in sub:
                bn(sub["BatchNorm_0"], name, "BatchNorm_0", f"{base}norm")
        else:
            raise KeyError(f"unexpected XDenseUNet parameter group {name!r}")
    return sd


_SCALARS = ("rho_iters", "rho1_iters", "rho2_iters", "lam_raw")


def model_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """flax variables of any solver of the zoo -> this package's state_dict.

    ``params`` holds some of ``ResUNet_0``, ``SubNet_0``, ``XDenseUNet_0``
    and the learnt scalars; BatchNorm statistics come from ``batch_stats``
    (without it, parameters only).
    """
    sd: dict = {}
    for name, sub in params.items():
        stats = None if batch_stats is None else batch_stats.get(name)
        if name == "ResUNet_0":
            sd.update(resunet_state_dict(sub, "resunet."))
        elif name == "SubNet_0":
            sd.update(subnet_state_dict(sub, stats, "subnet."))
        elif name == "XDenseUNet_0":
            sd.update(xdense_unet_state_dict(sub, stats, "xdense_unet."))
        elif name in _SCALARS:
            sd[name] = sub
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def _without_masked(tree: Mapping) -> dict:
    """``tree`` without optax's empty ``MaskedNode`` leaves and the groups they empty."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _without_masked(v)
            if v:
                out[k] = v
        elif not (isinstance(v, tuple) and not v):
            out[k] = v
    return out


def train_state_payload(params: Mapping, batch_stats: Mapping | None, adam_mu: Mapping, adam_nu: Mapping,
                        adam_count, step) -> dict:
    """A JAX ``TrainState`` trained with ``default_optimizer`` (or its
    ``multi_transform`` with frozen parameters) -> this package's checkpoint
    payload (``train/checkpoint.py::load_payload``).

    ``adam_mu``, ``adam_nu`` and ``adam_count`` are the fields of the
    ``ScaleByAdamState`` in the optax chain's state, as numpy.
    """
    return {"step": int(step), "model": model_state_dict(params, batch_stats),
            "opt_state": {"count": int(adam_count), "mu": model_state_dict(_without_masked(adam_mu)),
                          "nu": model_state_dict(_without_masked(adam_nu))}}
