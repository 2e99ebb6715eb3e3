"""Evaluation, the train steps, the orchestration of every track, the
adversarial steps, checkpoints, weight conversion and the completion of a
user's scans (``infer_files``)."""

from svdformer_pointsea_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from svdformer_pointsea_tpu_torch.train.infer import infer_files
from svdformer_pointsea_tpu_torch.train.loop import (
    build_model,
    init_state,
    load_weights_into_state,
    make_lr_fn,
    test_net,
    train_net,
    train_net_gan,
)
from svdformer_pointsea_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_train_step,
    reference_lr_schedule,
)

__all__ = [
    "CheckpointManager",
    "TrainState",
    "build_model",
    "infer_files",
    "init_state",
    "load_weights_into_state",
    "make_lr_fn",
    "make_optimizer",
    "make_train_step",
    "reference_lr_schedule",
    "restore_checkpoint",
    "save_checkpoint",
    "test_net",
    "train_net",
    "train_net_gan",
]
