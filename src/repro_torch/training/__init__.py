"""Training: AdamW, the single-card, data-parallel and tensor-parallel
train steps, checkpoints."""

from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            schedule)
from repro_torch.training.train_loop import (init_training, make_loss_fn,
                                             make_manual_dp_train_step,
                                             make_tp_train_step,
                                             make_train_step)

__all__ = [
    "latest_step", "restore_checkpoint", "save_checkpoint",
    "OptConfig", "adamw_update", "global_norm", "init_opt_state", "schedule",
    "init_training", "make_loss_fn", "make_manual_dp_train_step",
    "make_tp_train_step", "make_train_step",
]
