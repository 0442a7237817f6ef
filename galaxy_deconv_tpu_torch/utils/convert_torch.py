"""The reference's own PyTorch checkpoints -> this package's state_dicts
(counterpart of ``galaxy_deconv_tpu/utils/convert_torch.py``, which carries
them into flax's layout).

The reference's ``saved_models/*.pth`` (Tikhonet and ShapeNet on XDenseUNet,
the ResUNet-based ADMM solvers) hold torch modules, and so does this package,
so a tensor keeps its layout and only its key changes: OIHW convolutions,
(I, O, kh, kw) transposed convolutions (no flip: the flip the JAX converter
applies is flax's, and this package's bridge undoes it), (out, in) dense
layers, BatchNorm's weight, bias and running statistics.  One tensor moves:
the SubNet's first dense layer.  The reference flattens its (16, 8, 8)
feature map in CHW order; this package's SubNet flattens in flax's HWC order
(``nets/subnet.py``), so the layer's input columns are permuted, the alpha
column staying last.  BatchNorm's ``num_batches_tracked`` (no counterpart in
flax, unused by this package's BatchNorm) starts at 0.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from galaxy_deconv_tpu_torch.models.tikhonet import _SOFTPLUS_INV_1


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bn(src: str, dst: str) -> dict:
    return {f"{src}.{k}": f"{dst}.{k}" for k in ("weight", "bias", "running_mean", "running_var")}


# (reference module path, this package's index, kind, dense-block layers) of XDenseUNet
_XDENSE_LAYOUT = [
    ("input.0", None, "head", None),
    ("input.1", 0, "dense", 4),
    ("down1.0", 0, "down", None),
    ("down1.1", 1, "dense", 5),
    ("down2.0", 1, "down", None),
    ("down2.1", 2, "dense", 6),
    ("body.0", 2, "down", None),
    ("body.1", 3, "dense", 7),
    ("body.2", 0, "up", None),
    ("up1.0", 4, "dense", 6),
    ("up1.1", 1, "up", None),
    ("up2.0", 5, "dense", 5),
    ("up2.1", 2, "up", None),
    ("output.0", 6, "dense", 4),
    ("output.1", None, "tail", None),
]


def xdense_unet_keys(src: str = "", dst: str = "") -> dict[str, str]:
    """The reference XDenseUNet's keys (under ``src``) -> XDenseUNet's (under ``dst``)."""
    keys: dict[str, str] = {}
    for path, k, kind, layers in _XDENSE_LAYOUT:
        t = src + path
        if kind == "head":
            keys[f"{t}.weight"] = f"{dst}head.weight"
        elif kind == "tail":
            keys.update({f"{t}.weight": f"{dst}tail.weight", f"{t}.bias": f"{dst}tail.bias"})
        elif kind == "down":
            keys.update(_bn(f"{t}.net.0", f"{dst}downs.{k}.norm"))
            keys[f"{t}.net.2.weight"] = f"{dst}downs.{k}.conv.weight"
        elif kind == "up":
            keys.update({f"{t}.net.0.weight": f"{dst}ups.{k}.conv.weight", f"{t}.net.0.bias": f"{dst}ups.{k}.conv.bias"})
        else:
            for i in range(layers):
                keys.update(_bn(f"{t}.net.{i}.0", f"{dst}blocks.{k}.norms.{i}"))
                keys[f"{t}.net.{i}.2.depthewise.weight"] = f"{dst}blocks.{k}.convs.{i}.depthwise.weight"
                keys[f"{t}.net.{i}.2.pointwise.weight"] = f"{dst}blocks.{k}.convs.{i}.pointwise.weight"
    return keys


def resunet_keys(src: str = "", dst: str = "", num_blocks: int = 2) -> dict[str, str]:
    """The reference ResUNet's keys -> ResUNet's.  Reference layout: m_head;
    m_down{1..3} = [nb ResBlocks, strided conv]; m_body = nb ResBlocks;
    m_up{3..1} = [transposed conv, nb ResBlocks]; m_tail.  This package keeps
    the residual blocks in call order in ``resblocks``."""
    nb = num_blocks
    keys = {f"{src}m_head.weight": f"{dst}head.weight", f"{src}m_tail.weight": f"{dst}tail.weight"}
    blocks = [f"m_down{d}.{i}" for d in (1, 2, 3) for i in range(nb)] + [f"m_body.{i}" for i in range(nb)]
    blocks += [f"m_up{u}.{i + 1}" for u in (3, 2, 1) for i in range(nb)]
    for k, b in enumerate(blocks):
        keys[f"{src}{b}.res.0.weight"] = f"{dst}resblocks.{k}.conv0.weight"
        keys[f"{src}{b}.res.2.weight"] = f"{dst}resblocks.{k}.conv1.weight"
    for k, d in enumerate((1, 2, 3)):
        keys[f"{src}m_down{d}.{nb}.weight"] = f"{dst}downs.{k}.weight"
    for k, u in enumerate((3, 2, 1)):
        keys[f"{src}m_up{u}.0.weight"] = f"{dst}ups.{k}.weight"
    return keys


def subnet_keys(src: str = "", dst: str = "") -> dict[str, str]:
    """The reference SubNet's keys -> SubNet's: 4 x Down(maxpool +
    DoubleConv[conv BN relu conv BN relu]), then the 3-layer MLP."""
    keys: dict[str, str] = {}
    for i in range(4):
        base = f"{src}conv_layers.{i}.maxpool_conv.1.double_conv"
        for j, (conv, bn) in enumerate(((0, 1), (3, 4))):
            keys.update({f"{base}.{conv}.weight": f"{dst}convs.{i}.conv{j}.weight",
                         f"{base}.{conv}.bias": f"{dst}convs.{i}.conv{j}.bias"})
            keys.update(_bn(f"{base}.{bn}", f"{dst}convs.{i}.bn{j}"))
    for k, layer in enumerate((0, 2, 4)):
        keys.update({f"{src}mlp.{layer}.weight": f"{dst}dense.{k}.weight",
                     f"{src}mlp.{layer}.bias": f"{dst}dense.{k}.bias"})
    return keys


def subnet_first_dense_weight(w) -> np.ndarray:
    """The SubNet's first dense weight (64, 16*8*8 + 1), its input columns from
    the reference's CHW flatten order to this package's HWC order."""
    w = _np(w)
    c, h, wd = 16, 8, 8
    n_feat = w.shape[1] - 1
    assert n_feat == c * h * wd, w.shape
    j = np.arange(n_feat)
    hh, ww, cc = j // (wd * c), (j // c) % wd, j % c  # HWC position of column j
    return w[:, np.concatenate([cc * (h * wd) + hh * wd + ww, [n_feat]])]


def _convert(sd: Mapping, keys: Mapping[str, str], subnet_dst: str | None = None) -> dict[str, torch.Tensor]:
    out = {dst: _np(sd[src]) for src, dst in keys.items()}
    if subnet_dst is not None:
        out[f"{subnet_dst}dense.0.weight"] = subnet_first_dense_weight(out[f"{subnet_dst}dense.0.weight"])
    for dst in [k for k in out if k.endswith(".running_mean")]:
        out[dst.replace(".running_mean", ".num_batches_tracked")] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def convert_xdense_state_dict(sd: Mapping, prefix: str = "", out_prefix: str = "") -> dict[str, torch.Tensor]:
    """A reference XDenseUNet state_dict (its keys under ``prefix``) ->
    XDenseUNet state_dict entries (under ``out_prefix``)."""
    return _convert(sd, xdense_unet_keys(prefix, out_prefix))


def convert_resunet_state_dict(sd: Mapping, prefix: str = "", out_prefix: str = "",
                               num_blocks: int = 2) -> dict[str, torch.Tensor]:
    """A reference ResUNet state_dict -> ResUNet state_dict entries."""
    return _convert(sd, resunet_keys(prefix, out_prefix, num_blocks))


def convert_subnet_state_dict(sd: Mapping, prefix: str = "", out_prefix: str = "") -> dict[str, torch.Tensor]:
    """A reference SubNet state_dict (Gaussian n or Poisson 2n outputs) ->
    SubNet state_dict entries."""
    return _convert(sd, subnet_keys(prefix, out_prefix), subnet_dst=out_prefix)


def convert_tikhonet_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """A reference Tikhonet (or ShapeNet) checkpoint -> ``models.Tikhonet``'s
    state_dict.  The reference's ``lam`` was never registered as a parameter,
    so ``lam_raw`` takes its effective value, softplus(lam_raw) = 1."""
    out = convert_xdense_state_dict(sd, "denoiser.", "xdense_unet.")
    out["lam_raw"] = torch.tensor(np.float32(_SOFTPLUS_INV_1))
    return out


def convert_unrolled_admm_gaussian_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """A reference flagship (``UnrolledADMMGaussian``) state_dict ->
    ``models.UnrolledADMMGaussian``'s: ``init`` is the SubNet, ``Z.net`` the
    ResUNet(32, 64, 128, 256); the x-update has no parameters."""
    return {**convert_subnet_state_dict(sd, "init.", "subnet."), **convert_resunet_state_dict(sd, "Z.net.", "resunet.")}


def convert_unrolled_admm_state_dict(sd: Mapping, denoiser: str = "ResUNet") -> dict[str, torch.Tensor]:
    """A reference two-dual ``Unrolled_ADMM`` (Poisson or Gaussian) state_dict
    -> ``models.UnrolledADMM``'s: the SubNet of 2n outputs under ``init``,
    the ResUNet(64, ..., 512) or the XDenseUNet under ``Z.net``."""
    out = convert_subnet_state_dict(sd, "init.", "subnet.")
    if denoiser == "ResUNet":
        return {**out, **convert_resunet_state_dict(sd, "Z.net.", "resunet.")}
    return {**out, **convert_xdense_state_dict(sd, "Z.net.", "xdense_unet.")}


def convert_admmnet_state_dict(sd: Mapping, denoiser: str = "ResUNet") -> dict[str, torch.Tensor]:
    """A reference ADMMNet state_dict (its only parameters the frozen denoiser
    under ``Z.net``) -> ``models.ADMMNet``'s."""
    if denoiser == "ResUNet":
        return convert_resunet_state_dict(sd, "Z.net.", "resunet.")
    return convert_xdense_state_dict(sd, "Z.net.", "xdense_unet.")


def load_reference_tikhonet(pth_path: str) -> dict[str, torch.Tensor]:
    """A reference Tikhonet/ShapeNet ``.pth`` checkpoint as ``models.Tikhonet``'s state_dict."""
    return convert_tikhonet_state_dict(torch.load(pth_path, map_location="cpu"))
