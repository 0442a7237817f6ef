"""Train the learned model zoo online on the card, one model after another
(counterpart of ``scripts/train_zoo.py``).

Each model trains with ``train/online.py::fit_online``: every batch rendered
on the device by the simulator, Adam with a cosine schedule and clip 1.0,
logs every 500 steps, validation every 1,000, a checkpoint at every new best
validation and at the last step, and the history file that
``train/checkpoint.py::best_epoch`` reads.

Usage: python scripts/train_zoo_torch.py --models admm4 admm2 tikhonet --steps 15000 [--device cpu]
"""

import argparse
import logging
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from galaxy_deconv_tpu_torch.data import simulate as sim  # noqa: E402
from galaxy_deconv_tpu_torch.data.simulate import SimulationConfig  # noqa: E402
from galaxy_deconv_tpu_torch.losses import build_loss  # noqa: E402
from galaxy_deconv_tpu_torch.models import ResUNetDenoiser, Tikhonet, UnrolledADMM, UnrolledADMMGaussian  # noqa: E402
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer  # noqa: E402
from galaxy_deconv_tpu_torch.train.checkpoint import STATE_FILE  # noqa: E402
from galaxy_deconv_tpu_torch.train.online import fit_online  # noqa: E402
from galaxy_deconv_tpu_torch.utils.device import resolve_device  # noqa: E402
from galaxy_deconv_tpu_torch.utils.watchdog import StallWatchdog  # noqa: E402

# key -> (run name, model kind, model kwargs, loss name)
SPECS = {
    "admm8": ("Gaussian_PnP_ADMM_8iters_MultiScale", "admm", dict(n_iters=8), "MultiScale"),
    "admm4": ("Gaussian_PnP_ADMM_4iters_MultiScale", "admm", dict(n_iters=4), "MultiScale"),
    "admm2": ("Gaussian_PnP_ADMM_2iters_MultiScale", "admm", dict(n_iters=2), "MultiScale"),
    "tikhonet": ("Tikhonet_Laplacian_MultiScale", "tikhonet", dict(filter="Laplacian"), "MultiScale"),
    # ShapeNet = Tikhonet trained with the shape-constraint loss
    "shapenet": ("ShapeNet_Laplacian", "tikhonet", dict(filter="Laplacian"), "Shape"),
    # the flagship trained with the shape-constraint loss
    "admm8_shape": ("Gaussian_PnP_ADMM_8iters_Shape", "admm", dict(n_iters=8), "Shape"),
    "admm4_shape": ("Gaussian_PnP_ADMM_4iters_Shape", "admm", dict(n_iters=4), "Shape"),
    "admm8_moment": ("Gaussian_PnP_ADMM_8iters_MomentBased", "admm", dict(n_iters=8), "MomentBasedLoss"),
    "admm2_moment": ("Gaussian_PnP_ADMM_2iters_MomentBased", "admm", dict(n_iters=2), "MomentBasedLoss"),
    "admm2_ellipse": ("Gaussian_PnP_ADMM_2iters_BestEllipse", "admm", dict(n_iters=2), "BestEllipse"),
    # the Poisson-likelihood two-dual ADMM
    "poisson8": ("Poisson_PnP_ADMM_8iters_MultiScale", "admm_poisson", dict(n_iters=8), "MultiScale"),
    "resunet": ("ResUNet_MultiScale", "resunet", {}, "MultiScale"),
    # the denoiser trained on stamps divided by alpha, the scale of ADMMNet's loop variable
    "resunet_unit": ("ResUNet_Unit_MultiScale", "resunet_unit", {}, "MultiScale"),
    # every unrolled iteration's penalty kept in [0.1, 10] (UnrolledADMMGaussian.rho_bounds)
    "admm8_bounded": ("Gaussian_PnP_ADMM_8iters_Bounded_MultiScale", "admm",
                      dict(n_iters=8, rho_bounds=(0.1, 10.0)), "MultiScale"),
    "admm4_bounded": ("Gaussian_PnP_ADMM_4iters_Bounded_MultiScale", "admm",
                      dict(n_iters=4, rho_bounds=(0.1, 10.0)), "MultiScale"),
    "admm2_bounded": ("Gaussian_PnP_ADMM_2iters_Bounded_MultiScale", "admm",
                      dict(n_iters=2, rho_bounds=(0.1, 10.0)), "MultiScale"),
}

# the flagship's denoiser widths, and the standalone denoiser's (the reference's ResUNet)
FEATURES = (32, 64, 128, 256)
DENOISER_FEATURES = (64, 128, 256, 512)
# fit_online's cadences, in steps
LOG_EVERY, VAL_EVERY = 500, 1000


def build(kind: str, kw: dict):
    """(model, sampler) of a spec's kind: the deconvolution models train on
    ``simulate_batch``, the denoisers on the denoising task's batches."""
    if kind == "admm":
        return UnrolledADMMGaussian(features=FEATURES, **kw), sim.simulate_batch
    if kind == "admm_poisson":
        # the reference's denoiser widths (64, 128, 256, 512), the model's default
        return UnrolledADMM(llh="Poisson", **kw), sim.simulate_batch
    if kind == "tikhonet":
        return Tikhonet(**kw), sim.simulate_batch
    if kind == "resunet_unit":
        return ResUNetDenoiser(DENOISER_FEATURES), sim.simulate_batch_denoise_unit
    return ResUNetDenoiser(DENOISER_FEATURES), sim.simulate_batch_denoise


def warm_start(model: torch.nn.Module, path) -> None:
    """Load the weights and BatchNorm statistics of a port checkpoint (its
    directory, e.g. ``trained_torch/<run>_<N>epochs``, or its file) into ``model``."""
    path = pathlib.Path(path)
    payload = torch.load(path / STATE_FILE if path.is_dir() else path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--models", nargs="+", default=["admm4", "admm2"], choices=list(SPECS))
    parser.add_argument("--steps", type=int, default=15000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--save_path", default="saved_models_online_torch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps_per_call", type=int, default=10,
                        help="train steps queued back to back per call, the host waiting once per call")
    parser.add_argument(
        "--init_from", default=None,
        help="port checkpoint (a {name}_{N}epochs directory holding train_state.pt, e.g. as "
             "scripts/trained_to_port.py writes it) to warm-start the FIRST model in --models")
    parser.add_argument(
        "--suffix", default="",
        help="appended to every run name (e.g. _cont), keeping continuation "
             "checkpoints separate from the original run's")
    parser.add_argument("--snr_min", type=float, default=None,
                        help="override SimulationConfig.snr_min for the training SNR distribution")
    parser.add_argument("--snr_max", type=float, default=None, help="override SimulationConfig.snr_max")
    parser.add_argument("--snr_power", type=float, default=None,
                        help="override SimulationConfig.snr_power (p(snr) ∝ snr^-power; "
                             "larger = more low-SNR emphasis, 1.0 = log-uniform)")
    parser.add_argument("--flux_norm_loss", action="store_true",
                        help="per-sample flux normalization in the MultiScale loss "
                             "(equal gradient weight for faint/low-SNR stamps)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    # fit_online's own watchdog covers the training loop; this one covers the
    # first render and the model's set-up, and hands off at fit time
    init_dog = StallWatchdog(600.0, name="train_zoo[init]").start()
    overrides = {k: getattr(args, k) for k in ("snr_min", "snr_max", "snr_power") if getattr(args, k) is not None}
    cfg = SimulationConfig(**overrides)
    if overrides:
        print(f"simulation overrides: {overrides}")
    for key in args.models:
        name, kind, kw, loss_name = SPECS[key]
        name += args.suffix
        model, sampler = build(kind, kw)
        model = model.to(device)
        sample = sampler(0, 2, cfg, device=device)  # the first render, as the JAX script's init sample
        if not torch.isfinite(sample["obs"]).all():
            raise RuntimeError(f"{name}: the simulator rendered non-finite observations")
        optimizer = default_optimizer(args.lr, schedule="cosine", total_steps=args.steps)
        state, optimizer = create_train_state(model, 0, optimizer)
        if args.init_from and key == args.models[0]:
            warm_start(model, args.init_from)
            print(f"warm-started {name} from {args.init_from}")
        init_dog.stop()  # hand off to fit_online's own loop watchdog
        print(f"=== training {name} for {args.steps} steps ===")
        loss_kw = {"flux_normalize": True} if args.flux_norm_loss and loss_name == "MultiScale" else {}
        state, hist = fit_online(
            model, state, optimizer, build_loss(loss_name, **loss_kw), n_steps=args.steps,
            batch_size=args.batch, sim_cfg=cfg, seed=args.seed, log_every=LOG_EVERY, val_every=VAL_EVERY,
            model_name=name, save_path=args.save_path, save_every=args.steps,
            sampler=sampler, steps_per_call=args.steps_per_call,
        )
        init_dog = StallWatchdog(600.0, name="train_zoo[init]").start()
        val = hist["val_loss"]
        summary = f"final val={val[-1]:.5g} best={min(val):.5g}" if val else "no val evals (steps < val_every)"
        print(f"{name}: {summary} ({hist['galaxies_per_sec']:.0f} gal/s)")
    init_dog.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
