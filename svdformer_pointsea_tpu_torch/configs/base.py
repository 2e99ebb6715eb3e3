"""The configuration fields the PCN track reads: the evaluation path, the
train step and the ``main_pcn`` orchestration (values of
svdformer_pointsea_tpu/configs/base.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


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
    """Dataset paths and sizes (config_pcn.py). The paths are relative to
    the working directory, as in the reference."""

    name: str = "ShapeNet"  # PCN; the other tracks are ROADMAP queue A items 10 and 13
    category_file: str = "datasets/ShapeNet.json"
    n_renderings: int = 8  # partial scans per training model
    n_points: int = 2048  # points of a partial cloud
    partial_points_path: str = "./dataset/PCN/%s/partial/%s/%s/%02d.pcd"
    complete_points_path: str = "./dataset/PCN/%s/complete/%s/%s.pcd"
    gt_points: int = 16384  # points of a complete cloud
    num_workers: int = 4  # loader IO threads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings (config_pcn.py) and the run's switches."""

    batch_size: int = 12
    n_epochs: int = 400
    save_freq: int = 50  # ckpt-epoch-NNN every save_freq epochs
    learning_rate: float = 1e-4
    lr_decay_step: Sequence[int] = (40, 80, 120, 160, 200, 240, 280, 320, 360)  # MultiStep epochs
    warmup_steps: int = 300
    gamma: float = 0.7
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    sqrt_loss: bool = True  # chamfer_sqrt (CD-L1-style) pyramid loss
    # "f32" (reference-faithful) or "bf16": bf16 image trunk and flash
    # attention inputs, parameters and optimizer f32 (nn/precision.py).
    precision: str = "f32"
    progress: bool = False  # live per-batch loss line on stderr
    # Not ported yet; train_net refuses any other value (ROADMAP queue A).
    sp: int = 1  # sequence parallelism (item 15)
    dp: str = "gspmd"  # "shard_map" data parallelism (item 15)
    adv_enabled: bool = False  # the adversarial branch of the 55 track (item 10)


@dataclasses.dataclass(frozen=True)
class Config:
    network: NetworkConfig = NetworkConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    out_path: str = "out/svdformer_pcn"
    weights: Optional[str] = None  # checkpoint to resume from or to test
    seed: int = 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def pcn_config() -> Config:
    """SVDFormer on PCN (config_pcn.py)."""
    return Config()
