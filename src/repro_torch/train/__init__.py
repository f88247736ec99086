"""Training (port of ``repro/train``): the loss, the train step with its
gradient synchronisation, and the trainer loop."""
from .losses import cross_entropy
from .train_step import (Mesh, TrainConfig, init_train_state, make_loss_fn,
                         make_mesh, make_train_step, value_and_grad)
from .trainer import Trainer, TrainerConfig

__all__ = ["Mesh", "TrainConfig", "Trainer", "TrainerConfig", "cross_entropy",
           "init_train_state", "make_loss_fn", "make_mesh", "make_train_step",
           "value_and_grad"]
