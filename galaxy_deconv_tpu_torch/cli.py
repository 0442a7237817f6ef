"""Command-line interface of the port (counterpart of ``galaxy_deconv_tpu/cli.py``).

    python -m galaxy_deconv_tpu_torch generate --data_path DIR [--task Denoise] [--device cpu] ...
    python -m galaxy_deconv_tpu_torch train --data_path DIR [--model Tikhonet|ShapeNet|ResUNet] [--device cpu] ...
    python -m galaxy_deconv_tpu_torch train --online --n_steps N [--steps_per_call K] [--device cpu] ...
    python -m galaxy_deconv_tpu_torch test --data_path DIR --test shear [--methods ...] [--device cpu] ...
    python -m galaxy_deconv_tpu_torch bench [--batch_size 1024] [--repeats 10] [--dtype float32] [--device cpu]
    torchrun --nproc_per_node N -m galaxy_deconv_tpu_torch train|test --n_devices N ...

``generate`` simulates a benchmark dataset, or with ``--task Denoise`` the
denoising task's (the reference's ``generate_data.py``); ``train`` trains the
flagship ``Unrolled_ADMM`` (``--remove_SubNet`` for the learnt-vector
schedule), a Tikhonet (``--filter``), ShapeNet (a Tikhonet trained with the
Shape loss) or, on a Denoise tree, the standalone ResUNet, in float32 with
TF32 off, and checkpoints into ``--model_save_path`` as the reference's
``train.py`` does; ``train --online`` renders every batch on the device
instead of reading a dataset (``train/online.py``); ``test`` runs the evaluation sweeps of
the reference's ``test.py`` and ``test_psf.py`` over a method list of any
registry names; ``bench`` times the flagship pipeline on ``bench.py``'s
stamps and prints its JSON line (``galaxy_deconv_tpu_torch/bench.py``).
Each runs on the card unless ``--device cpu``.

``train`` (from a dataset) and ``test`` run data parallel under a launcher
that starts one process per device, as the JAX CLI runs them on a mesh of
every device: each joins the process group (``parallel.initialize_distributed``:
NCCL on the card, gloo on the CPU) and builds the mesh of ``--n_devices``
ranks, which must be the world size.  ``train --online`` runs on one device.
"""

from __future__ import annotations

import argparse
import logging
import os

from galaxy_deconv_tpu_torch import bench
from galaxy_deconv_tpu_torch.config import add_args, from_namespace
from galaxy_deconv_tpu_torch.data import GalaxyDataset, SimulationConfig, generate_dataset, generate_dataset_denoise
from galaxy_deconv_tpu_torch.data.simulate import simulate_batch, simulate_batch_denoise
from galaxy_deconv_tpu_torch.eval import DEFAULT_PSF_ERRS, run_psf_error_test, run_shear_test, run_time_test
from galaxy_deconv_tpu_torch.losses import build_loss, get_model_name
from galaxy_deconv_tpu_torch.models import ResUNetDenoiser, Tikhonet, UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.parallel import initialize_distributed, make_mesh
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer, fit, restore_checkpoint
from galaxy_deconv_tpu_torch.train.checkpoint import best_epoch, unpack_variables
from galaxy_deconv_tpu_torch.train.online import fit_online
from galaxy_deconv_tpu_torch.utils.device import resolve_device


def _cmd_generate(ns):
    cfg = SimulationConfig(pupil_n=ns.pupil_n, pupil_pad=2 * ns.pupil_n)
    common = dict(n_train=ns.n_train, n_test=ns.n_test, cfg=cfg, seed=ns.seed, chunk=ns.chunk, device=ns.device)
    if ns.task == "Denoise":
        root = generate_dataset_denoise(ns.data_path, **common)
    else:
        root = generate_dataset(ns.data_path, shear_errs=tuple(ns.errs), fwhm_errs=tuple(ns.errs), **common)
    print(f"dataset written to {root}")
    return root


def _cmd_train(ns):
    cfg = from_namespace(ns)
    if ns.online:  # JAX's fit_online takes no mesh
        if cfg.n_devices not in (None, 1) or int(os.environ.get("WORLD_SIZE", 1)) > 1:
            raise SystemExit("train --online runs on one device, in one process")
        device, mesh = resolve_device(cfg.device), None
    else:
        initialize_distributed(cfg.device)
        mesh = make_mesh(cfg.n_devices, cfg.device)
        device = mesh.device
    model_name = get_model_name(cfg.model, cfg.loss, filter=cfg.filter, n_iters=cfg.n_iters, llh=cfg.llh,
                                remove_subnet=cfg.remove_subnet)
    logging.info("training %s on %s (%s)", model_name, "simulated batches" if ns.online else cfg.data_path, device)

    if cfg.model == "Unrolled_ADMM":
        # train.py:41 -- the Gaussian flagship whatever --llh says
        model = UnrolledADMMGaussian(n_iters=cfg.n_iters, subnet=not cfg.remove_subnet, fft_impl=cfg.fft_impl)
    elif cfg.model in ("Tikhonet", "ShapeNet"):
        model = Tikhonet(filter=cfg.filter)
    else:  # ResUNet, on a Denoise tree
        model = ResUNetDenoiser()
    model = model.to(device)
    loss_fn = build_loss("Shape" if cfg.model == "ShapeNet" else cfg.loss)
    state, optimizer = create_train_state(model, cfg.seed, default_optimizer(cfg.lr))

    if ns.online:  # no dataset: every batch rendered on the device
        sampler = simulate_batch_denoise if cfg.model == "ResUNet" else simulate_batch
        state, hist = fit_online(model, state, optimizer, loss_fn, n_steps=ns.n_steps, batch_size=cfg.batch_size,
                                 sim_cfg=SimulationConfig(), seed=cfg.seed, model_name=model_name,
                                 save_path=cfg.model_save_path, sampler=sampler, steps_per_call=ns.steps_per_call)
        if hist["train_loss"]:
            print(f"final train_loss={hist['train_loss'][-1]:.5g} val_loss={hist['val_loss'][-1]:.5g} "
                  f"({hist['galaxies_per_sec']:.0f} gal/s)")
        else:
            print(f"trained {ns.n_steps} steps ({hist['galaxies_per_sec']:.0f} gal/s)")
        return state, hist

    ds = GalaxyDataset(cfg.data_path, "train")
    if cfg.pretrained_epochs > 0:
        state = restore_checkpoint(cfg.model_save_path, model_name, cfg.pretrained_epochs, state)
        logging.info("resumed from epoch %d", cfg.pretrained_epochs)

    # fit's train and eval steps run with TF32 off
    state, hist = fit(model, state, optimizer, loss_fn, ds, n_epochs=cfg.n_epochs, batch_size=cfg.batch_size,
                      train_val_split=cfg.train_val_split, seed=cfg.seed, model_name=model_name,
                      save_path=cfg.model_save_path, mesh=mesh, pretrained_epochs=cfg.pretrained_epochs)
    print(f"final train_loss={hist['train_loss'][-1]:.5g} val_loss={hist['val_loss'][-1]:.5g}")
    return state, hist


DEFAULT_METHODS = (
    "No_Deconv",
    "FPFS",
    "Richard-Lucy(10)",
    "Richard-Lucy(20)",
    "Richard-Lucy(30)",
    "Richard-Lucy(50)",
    "Richard-Lucy(100)",
)


def _cmd_test(ns):
    cfg = from_namespace(ns)
    initialize_distributed(cfg.device)
    mesh = make_mesh(cfg.n_devices, cfg.device)
    methods = ns.methods or DEFAULT_METHODS

    state_dict = None
    if ns.checkpoint_name:
        # trained weights (the reference's model_file); 0 = the best-validation epoch of the run's history
        ep = ns.checkpoint_epoch or best_epoch(cfg.model_save_path, ns.checkpoint_name)
        if not ep:  # never the seed's weights in place of a missing checkpoint
            raise FileNotFoundError(f"no checkpoint of {ns.checkpoint_name} under {cfg.model_save_path}")
        state_dict = unpack_variables(restore_checkpoint(cfg.model_save_path, ns.checkpoint_name, ep))
        logging.info("loaded %s epoch %s", ns.checkpoint_name, ep)

    # a process alone takes the single-device bulk path; ranks of a group, the per-batch mesh path
    common = dict(n_gal=cfg.n_gal, batch_size=cfg.eval_batch_size, state_dict=state_dict, mesh=mesh)
    results = {}
    for method in methods:
        if cfg.test == "shear":
            results[method] = run_shear_test(method, cfg.data_path, cfg.result_path, snrs=tuple(cfg.snrs), **common)
        elif cfg.test == "time":
            results[method] = run_time_test(method, cfg.data_path, cfg.result_path, **common)
        else:
            kind = cfg.test.removeprefix("psf_")
            results[method] = run_psf_error_test(method, cfg.data_path, cfg.result_path, errs=ns.errs, kind=kind,
                                                 **common)
    return results


def _cmd_bench(ns):
    return bench.main(["--batch", str(ns.batch_size), "--repeats", str(ns.repeats), "--dtype", ns.dtype,
                       "--device", ns.device])


def main(argv=None):
    """Run one subcommand; returns what it returns (``generate``: the
    dataset's root; ``train``: the final train state and the history;
    ``test``: each method's results; ``bench``: its JSON record)."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="galaxy_deconv_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="simulate a benchmark dataset")
    g.add_argument("--data_path", type=str, required=True)
    g.add_argument("--n_train", type=int, default=40000)
    g.add_argument("--n_test", type=int, default=10000)
    g.add_argument("--pupil_n", type=int, default=512, help="pupil samples across; the FFT grid is twice that")
    g.add_argument("--chunk", type=int, default=256)
    g.add_argument("--seed", type=int, default=31415)
    g.add_argument("--task", type=str, default="Deconv", choices=["Deconv", "Denoise"],
                   help="Deconv: the benchmark dataset; Denoise: obs = gt + noise pairs, no PSF")
    g.add_argument("--errs", type=float, nargs="*", default=list(DEFAULT_PSF_ERRS),
                   help="levels of the perturbed-PSF sets, shear and FWHM (Deconv)")
    g.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    g.set_defaults(fn=_cmd_generate)

    t = sub.add_parser("train", help="train a model on a packed dataset or on batches rendered on the device")
    add_args(t)
    t.add_argument("--online", action="store_true",
                   help="render every batch on the device and train on it (no dataset)")
    t.add_argument("--n_steps", type=int, default=25000, help="steps for --online")
    t.add_argument("--steps_per_call", type=int, default=10,
                   help="--online steps queued back to back per call, the host waiting once per call")
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("test", help="evaluation sweeps")
    add_args(e)
    e.add_argument("--methods", type=str, nargs="*", default=None,
                   help="harness method names (default: No_Deconv, FPFS, Richard-Lucy(10-100))")
    e.add_argument("--checkpoint_name", type=str, default=None,
                   help="run name under --model_save_path to load weights from")
    e.add_argument("--checkpoint_epoch", type=int, default=0, help="0 = the best-validation epoch")
    e.add_argument("--errs", type=float, nargs="*", default=list(DEFAULT_PSF_ERRS))
    e.set_defaults(fn=_cmd_test)

    b = sub.add_parser("bench", help="throughput benchmark of the flagship pipeline")
    b.add_argument("--batch_size", type=int, default=1024)
    b.add_argument("--repeats", type=int, default=10)
    b.add_argument("--dtype", type=str, default="bfloat16", choices=list(bench.DTYPES),
                   help="the nets' compute type (the spectra stay float32)")
    b.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    b.set_defaults(fn=_cmd_bench)

    ns = parser.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    main()
