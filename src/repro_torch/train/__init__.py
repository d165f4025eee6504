"""Train step and fault-tolerant trainer (the port's ``repro/train``)."""

from repro_torch.train.train_step import build_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["build_train_step", "Trainer", "TrainerConfig"]
