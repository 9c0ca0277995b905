"""Training: the optimiser and LR schedule, the parameter EMA, and the train
step (the port of ``r2dm_tpu/training``)."""

from .ema import EMAConfig, ema_decay, ema_update
from .optim import cosine_schedule_with_warmup, make_optimizer, schedule_lr, set_schedule_step
from .step import TrainState, init_train_state, make_train_step

__all__ = [
    "EMAConfig", "TrainState", "cosine_schedule_with_warmup", "ema_decay", "ema_update",
    "init_train_state", "make_optimizer", "make_train_step", "schedule_lr", "set_schedule_step",
]
