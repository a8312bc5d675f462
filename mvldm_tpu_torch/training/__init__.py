from .checkpoint import CheckpointManager
from .optim import (
    LRSchedulerCfg,
    OptimizerCfg,
    build_lr_schedule,
    build_optimizer,
    ema_update,
)
from .trainer import TrainState, Trainer, batch_from_arrays, make_train_step

__all__ = [
    "CheckpointManager",
    "LRSchedulerCfg",
    "OptimizerCfg",
    "TrainState",
    "Trainer",
    "batch_from_arrays",
    "build_lr_schedule",
    "build_optimizer",
    "ema_update",
    "make_train_step",
]
