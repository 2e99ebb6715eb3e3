"""The configuration fields the PCN evaluation path and train step read
(values of svdformer_pointsea_tpu/configs/base.py)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """SVDFormer hyperparameters (config_pcn.py). PCSA and the SDG decoder
    are always on: every configuration this port has uses them."""

    step1: int = 4
    step2: int = 8
    merge_points: int = 512
    local_points: int = 512
    view_distance: float = 0.7
    resolution: int = 224  # self-view depth-image resolution


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n_points: int = 2048  # points of a partial cloud


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings (config_pcn.py)."""

    batch_size: int = 12
    learning_rate: float = 1e-4
    lr_decay_step: Sequence[int] = (40, 80, 120, 160, 200, 240, 280, 320, 360)  # MultiStep epochs
    warmup_steps: int = 300
    gamma: float = 0.7
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    sqrt_loss: bool = True  # chamfer_sqrt (CD-L1-style) pyramid loss


@dataclasses.dataclass(frozen=True)
class Config:
    network: NetworkConfig = NetworkConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def pcn_config() -> Config:
    """SVDFormer on PCN (config_pcn.py)."""
    return Config()
