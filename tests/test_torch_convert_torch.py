"""Port parity: the reference's PyTorch checkpoints into the port's state dicts
(galaxy_deconv_tpu_torch/utils/convert_torch.py) against the JAX package's
converter (galaxy_deconv_tpu/utils/convert_torch.py) followed by the port's
flax bridge (utils/convert_flax.py::model_state_dict).

The repo holds no reference checkpoint, so each test builds a synthetic
reference-layout state dict: the keys the JAX converter reads, each tensor
drawn from numpy seed 0 at the shape of the port module it lands in.  The two
routes must give the same state dict bit for bit, one that the port's model
loads strictly; the flagship's and Tikhonet's forwards on it must match JAX's
forward on JAX's converted variables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galaxy_deconv_tpu.models import Tikhonet as JTikhonet
from galaxy_deconv_tpu.models import UnrolledADMMGaussian as JFlagship
from galaxy_deconv_tpu.utils import convert_torch as J
from galaxy_deconv_tpu_torch.models import ADMMNet, Tikhonet, UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.models.unrolled_admm import UnrolledADMM
from galaxy_deconv_tpu_torch.nets.resunet import ResUNet
from galaxy_deconv_tpu_torch.nets.subnet import SubNet
from galaxy_deconv_tpu_torch.nets.xdense_unet import XDenseUNet
from galaxy_deconv_tpu_torch.utils import convert_torch as T
from galaxy_deconv_tpu_torch.utils import convert_flax
from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict


def reference_state_dict(keys: dict, model: torch.nn.Module, seed: int = 0) -> dict:
    """A reference-layout state dict: every reference key of ``keys`` (reference
    -> port), its tensor drawn at the shape of the port parameter it maps to:
    weights N(0, 1 / fan_in), as an initialisation scales them, so that a
    forward stays finite; vectors 0.1 N(0, 1), BatchNorm variances 0.5 + that."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for src, dst in keys.items():
        shape = shapes[dst]
        scale = 1 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.1
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        sd[src] = torch.from_numpy(np.abs(a) + 0.5 if src.endswith("running_var") else a)
    return sd


def bridged(variables: dict) -> dict:
    return model_state_dict(variables["params"], variables.get("batch_stats"))


def tensors(sd: dict) -> dict:
    """A numpy state dict of the bridge's net-level maps as tensors, as ``model_state_dict`` returns them."""
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# (name, port model, reference keys, port converter, JAX converter)
CASES = {
    "xdense_unet": (XDenseUNet, lambda: T.xdense_unet_keys("net.", ""),
                    lambda sd: T.convert_xdense_state_dict(sd, "net."),
                    lambda sd: tensors(convert_flax.xdense_unet_state_dict(*J.convert_xdense_state_dict(sd, "net.")))),
    "resunet": (lambda: ResUNet(features=(32, 64, 128, 256)), lambda: T.resunet_keys("m.", ""),
                lambda sd: T.convert_resunet_state_dict(sd, "m."),
                lambda sd: tensors(convert_flax.resunet_state_dict(J.convert_resunet_state_dict(sd, prefix="m.")))),
    "subnet": (lambda: SubNet(8), lambda: T.subnet_keys("init.", ""),
               lambda sd: T.convert_subnet_state_dict(sd, "init."),
               lambda sd: tensors(convert_flax.subnet_state_dict(*J.convert_subnet_state_dict(sd, prefix="init.")))),
    "tikhonet": (Tikhonet, lambda: T.xdense_unet_keys("denoiser.", "xdense_unet."),
                 T.convert_tikhonet_state_dict, lambda sd: bridged(J.convert_tikhonet_state_dict(sd))),
    "unrolled_admm_gaussian": (
        UnrolledADMMGaussian,
        lambda: {**T.subnet_keys("init.", "subnet."), **T.resunet_keys("Z.net.", "resunet.")},
        T.convert_unrolled_admm_gaussian_state_dict,
        lambda sd: bridged(J.convert_unrolled_admm_gaussian_state_dict(sd))),
    "unrolled_admm_resunet": (
        UnrolledADMM, lambda: {**T.subnet_keys("init.", "subnet."), **T.resunet_keys("Z.net.", "resunet.")},
        T.convert_unrolled_admm_state_dict, lambda sd: bridged(J.convert_unrolled_admm_state_dict(sd))),
    "unrolled_admm_xdense": (
        lambda: UnrolledADMM(denoiser="XDenseUNet"),
        lambda: {**T.subnet_keys("init.", "subnet."), **T.xdense_unet_keys("Z.net.", "xdense_unet.")},
        lambda sd: T.convert_unrolled_admm_state_dict(sd, denoiser="XDenseUNet"),
        lambda sd: bridged(J.convert_unrolled_admm_state_dict(sd, denoiser="XDenseUNet"))),
    "admmnet_resunet": (ADMMNet, lambda: T.resunet_keys("Z.net.", "resunet."), T.convert_admmnet_state_dict,
                        lambda sd: bridged(J.convert_admmnet_state_dict(sd))),
    "admmnet_xdense": (lambda: ADMMNet(denoiser="XDenseUNet"), lambda: T.xdense_unet_keys("Z.net.", "xdense_unet."),
                       lambda sd: T.convert_admmnet_state_dict(sd, denoiser="XDenseUNet"),
                       lambda sd: bridged(J.convert_admmnet_state_dict(sd, denoiser="XDenseUNet"))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_converter_matches_jax_converter_and_bridge(case):
    # bit for bit, dtypes included; the port's model loads the result strictly
    # (every key it has, none it lacks)
    make, keys, port, jax_route = CASES[case]
    model = make()
    sd = reference_state_dict(keys(), model)
    got = port(sd)
    assert_same(got, jax_route(sd))
    model.load_state_dict(got)


def test_subnet_first_dense_columns_move_from_chw_to_hwc():
    # the reference flattens (16, 8, 8) in CHW order, the port's SubNet in HWC:
    # column j of the port's weight is the reference's column (c, h, w) of
    # the j-th HWC position; the alpha column stays last
    w = torch.arange(64 * 1025, dtype=torch.float32).reshape(64, 1025)
    got = T.subnet_first_dense_weight(w)
    j = 3 * 16 * 8 + 5 * 16 + 7  # h 3, w 5, c 7 in HWC order
    assert np.array_equal(got[:, j], w[:, 7 * 64 + 3 * 8 + 5].numpy())
    assert np.array_equal(got[:, -1], w[:, -1].numpy())


def test_load_reference_tikhonet_reads_a_pth(tmp_path):
    model = Tikhonet()
    sd = reference_state_dict(T.xdense_unet_keys("denoiser.", "xdense_unet."), model)
    torch.save(sd, tmp_path / "Tikhonet_Laplacian_50epochs.pth")
    assert_same(T.load_reference_tikhonet(str(tmp_path / "Tikhonet_Laplacian_50epochs.pth")),
                T.convert_tikhonet_state_dict(sd))


def stamps(B=2, seed=1):
    rng = np.random.default_rng(seed)
    gt = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 5
    psf = np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32)
    psf /= psf.sum(axis=(1, 2), keepdims=True) * 16
    obs = gt + rng.standard_normal((B, 48, 48)).astype(np.float32)
    return obs, psf, obs.mean(axis=(1, 2))


@pytest.mark.parametrize("case", ["unrolled_admm_gaussian", "tikhonet"])
def test_converted_forward_matches_jax(case):
    # eval mode on 2 stamps: the port's model on the port converter's state
    # dict against JAX's model on JAX's converted variables, at 1e-5 of the
    # peak (the flagship's two unrolled iterations and Tikhonet's XDenseUNet
    # run full-width float32 convolutions in another order; readings 1.5e-6
    # and 8.3e-7)
    make, keys, port, _ = CASES[case]
    if case == "unrolled_admm_gaussian":
        model, jmodel, jconv = UnrolledADMMGaussian(n_iters=2), JFlagship(n_iters=2), \
            J.convert_unrolled_admm_gaussian_state_dict
    else:
        model, jmodel, jconv = Tikhonet(), JTikhonet(), J.convert_tikhonet_state_dict
    sd = reference_state_dict(keys(), model)
    model.load_state_dict(port(sd))
    obs, psf, alpha = stamps()
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a) for a in (obs, psf, alpha))).numpy()
    want = np.asarray(jax.jit(lambda o, p, a: jmodel.apply(jconv(sd), o, p, a))(
        jnp.asarray(obs), jnp.asarray(psf), jnp.asarray(alpha)))
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
