"""Training of the port: losses, the optimizer chain and the trainer."""

from msau_tpu_torch.train.loss import masked_cross_entropy, unet_loss
from msau_tpu_torch.train.optimizer import make_optimizer, staircase_schedule
from msau_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "masked_cross_entropy",
    "unet_loss",
    "make_optimizer",
    "staircase_schedule",
    "Trainer",
    "TrainState",
    "make_eval_step",
    "make_train_step",
]
