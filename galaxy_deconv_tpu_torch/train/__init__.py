"""Training: train state and optimizer, checkpoints, and the three trainers
(the disk dataset's ``fit``, ``fit_online`` on batches rendered on the
device, ``fit_device_resident`` on a split uploaded to the device)."""

from galaxy_deconv_tpu_torch.train.checkpoint import (
    best_epoch,
    latest_epoch,
    restore_checkpoint,
    save_checkpoint,
    unpack_variables,
)
from galaxy_deconv_tpu_torch.train.device_resident import (
    fit_device_resident,
    make_indexed_multi_step,
    make_indexed_train_step,
    upload_split,
)
from galaxy_deconv_tpu_torch.train.loop import fit, make_eval_step, make_train_step
from galaxy_deconv_tpu_torch.train.online import (
    fit_online,
    make_online_eval_step,
    make_online_train_scan,
    make_online_train_step,
)
from galaxy_deconv_tpu_torch.train.state import (
    AdamState,
    ClippedAdam,
    TrainState,
    create_train_state,
    default_optimizer,
    update_is_good,
)

__all__ = ["AdamState", "ClippedAdam", "TrainState", "best_epoch", "create_train_state", "default_optimizer",
           "fit", "fit_device_resident", "fit_online", "latest_epoch", "make_eval_step", "make_indexed_multi_step",
           "make_indexed_train_step", "make_online_eval_step", "make_online_train_scan", "make_online_train_step",
           "make_train_step", "restore_checkpoint", "save_checkpoint", "unpack_variables", "update_is_good",
           "upload_split"]
