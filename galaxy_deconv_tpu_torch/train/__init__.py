"""Offline training: train state and optimizer, checkpoints, train loop."""

from galaxy_deconv_tpu_torch.train.checkpoint import (
    best_epoch,
    latest_epoch,
    restore_checkpoint,
    save_checkpoint,
    unpack_variables,
)
from galaxy_deconv_tpu_torch.train.loop import fit, make_eval_step, make_train_step
from galaxy_deconv_tpu_torch.train.state import (
    AdamState,
    ClippedAdam,
    TrainState,
    create_train_state,
    default_optimizer,
    update_is_good,
)

__all__ = ["AdamState", "ClippedAdam", "TrainState", "best_epoch", "create_train_state", "default_optimizer",
           "fit", "latest_epoch", "make_eval_step", "make_train_step", "restore_checkpoint", "save_checkpoint",
           "unpack_variables", "update_is_good"]
