"""Training substrate (port of ``repro/train``): optimizer, LR schedules,
loss, train step and checkpointing."""
from .loss import cross_entropy_loss
from .optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .step import TrainState, make_train_step, train_state_init, abstract_train_state

__all__ = [
    "AdamWConfig",
    "TrainState",
    "abstract_train_state",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "cross_entropy_loss",
    "make_train_step",
    "train_state_init",
]
