from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import FaultInjector, StepFailure, Trainer, TrainerConfig

__all__ = [
    "loss_and_grads", "make_train_step",
    "FaultInjector", "StepFailure", "Trainer", "TrainerConfig",
]
