"""Training: every preset's objective, the AdamW step, validation, the
schedules, the auxiliary losses and the VGG19 perceptual loss."""
from rife_tpu_torch.train.loop import (TrainState, eval_step, loss_fn,
                                       restore_checkpoint, save_checkpoint,
                                       train_init, train_step, vis_to_host)
from rife_tpu_torch.train.losses import epe_loss, sobel_loss, ternary_loss
from rife_tpu_torch.train.lr import cyclic_lr_schedule, warmup_cosine_schedule

__all__ = ["TrainState", "cyclic_lr_schedule", "epe_loss", "eval_step", "loss_fn",
           "restore_checkpoint", "save_checkpoint", "sobel_loss", "ternary_loss",
           "train_init", "train_step", "vis_to_host", "warmup_cosine_schedule"]
