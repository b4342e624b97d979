"""Training: the `rife` objective, AdamW step, validation and schedules."""
from rife_tpu_torch.train.loop import (TrainState, eval_step, loss_fn,
                                       restore_checkpoint, save_checkpoint,
                                       train_init, train_step)
from rife_tpu_torch.train.lr import cyclic_lr_schedule, warmup_cosine_schedule

__all__ = ["TrainState", "cyclic_lr_schedule", "eval_step", "loss_fn",
           "restore_checkpoint", "save_checkpoint", "train_init", "train_step",
           "warmup_cosine_schedule"]
