"""Evaluation, the train steps, the PCN, ShapeNet-55 and GeoSpecNet
orchestration, the adversarial steps, checkpoints and weight conversion."""

from svdformer_pointsea_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
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
