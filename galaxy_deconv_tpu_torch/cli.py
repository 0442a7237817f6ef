"""Command-line interface of the port (counterpart of ``galaxy_deconv_tpu/cli.py``).

    python -m galaxy_deconv_tpu_torch.cli train --data_path DIR [--device cpu] ...

``train`` trains the flagship ``Unrolled_ADMM`` (``--remove_SubNet`` for the
learnt-vector schedule) on a packed dataset, in float32 with TF32 off, and
checkpoints into ``--model_save_path`` as the reference's ``train.py`` does.
"""

from __future__ import annotations

import argparse
import logging

from galaxy_deconv_tpu_torch.config import add_args, from_namespace
from galaxy_deconv_tpu_torch.data import GalaxyDataset
from galaxy_deconv_tpu_torch.losses import build_loss, get_model_name
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.train import create_train_state, default_optimizer, fit, restore_checkpoint
from galaxy_deconv_tpu_torch.utils.device import resolve_device


def _cmd_train(ns):
    cfg = from_namespace(ns)
    if cfg.model != "Unrolled_ADMM":
        raise SystemExit(f"--model {cfg.model} is not ported yet (ROADMAP Queue 1 items 10-12)")
    device = resolve_device(cfg.device)
    model_name = get_model_name(cfg.model, cfg.loss, filter=cfg.filter, n_iters=cfg.n_iters, llh=cfg.llh,
                                remove_subnet=cfg.remove_subnet)
    logging.info("training %s on %s (%s)", model_name, cfg.data_path, device)

    # train.py:41 -- the Gaussian flagship whatever --llh says
    model = UnrolledADMMGaussian(n_iters=cfg.n_iters, subnet=not cfg.remove_subnet, fft_impl=cfg.fft_impl).to(device)
    loss_fn = build_loss(cfg.loss)
    ds = GalaxyDataset(cfg.data_path, "train")
    state, optimizer = create_train_state(model, cfg.seed, default_optimizer(cfg.lr))
    if cfg.pretrained_epochs > 0:
        state = restore_checkpoint(cfg.model_save_path, model_name, cfg.pretrained_epochs, state)
        logging.info("resumed from epoch %d", cfg.pretrained_epochs)

    # fit's train and eval steps run with TF32 off
    state, hist = fit(model, state, optimizer, loss_fn, ds, n_epochs=cfg.n_epochs, batch_size=cfg.batch_size,
                      train_val_split=cfg.train_val_split, seed=cfg.seed, model_name=model_name,
                      save_path=cfg.model_save_path, pretrained_epochs=cfg.pretrained_epochs)
    print(f"final train_loss={hist['train_loss'][-1]:.5g} val_loss={hist['val_loss'][-1]:.5g}")
    return state, hist


def main(argv=None):
    """Run one subcommand; returns what it returns (``train``: the final
    train state and the history)."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="galaxy_deconv_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train a model on a packed dataset")
    add_args(t)
    t.set_defaults(fn=_cmd_train)
    ns = parser.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    main()
