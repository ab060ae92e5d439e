"""Training layer: loss registry, scheduler, state and masked Adam, steps,
checkpoints and the trainer loop."""
from .checkpoint import CheckpointManager, load_params_only
from .loop import Trainer
from .losses import LOSS_LIST, anneal_epochs, loss_weights, \
    module_active_epochs
from .scheduler import LossScheduler, MetricLogger
from .state import Adam, TrainState, create_train_state, make_optimizer, \
    make_update_mask, reset_optimizer, set_learning_rate
from .step import (make_eval_step, make_generate_step, make_train_step,
                   total_loss)

__all__ = [
    "LOSS_LIST", "loss_weights", "anneal_epochs", "module_active_epochs",
    "LossScheduler", "MetricLogger", "Adam", "TrainState", "make_optimizer",
    "make_update_mask", "create_train_state", "set_learning_rate",
    "reset_optimizer", "make_train_step", "make_eval_step",
    "make_generate_step", "total_loss",
    "CheckpointManager", "load_params_only", "Trainer",
]
