"""Evaluation, the train step, model construction and weight conversion."""

from svdformer_pointsea_tpu_torch.train.loop import build_model, init_state, make_lr_fn
from svdformer_pointsea_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_train_step,
    reference_lr_schedule,
)

__all__ = [
    "TrainState",
    "build_model",
    "init_state",
    "make_lr_fn",
    "make_optimizer",
    "make_train_step",
    "reference_lr_schedule",
]
