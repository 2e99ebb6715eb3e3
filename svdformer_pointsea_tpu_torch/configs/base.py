"""The configuration fields the PCN, ShapeNet-55, GeoSpecNet and PointSea
tracks read: the evaluation paths, the train steps and the ``main_pcn`` /
``main_55`` / ``main_geospec`` / ``main_pointsea`` orchestration (values of
svdformer_pointsea_tpu/configs/base.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Generator hyperparameters (config_pcn.py / config_55.py /
    config_geospec.py). SVDFormer always runs PCSA in its SA modules,
    GeoSpecNet and PointSea never."""

    step1: int = 4
    step2: int = 8
    merge_points: int = 512
    local_points: int = 512
    view_distance: float = 0.7
    # "sdg" (PCN: SDG_Decoder stacks) or "attn" (ShapeNet-55: one
    # self-attention block as each SDG decoder).
    decoder: str = "sdg"
    resolution: int = 224  # self-view depth-image resolution (PointSea's renders are 224²)
    model: str = "svdformer"  # "svdformer" | "geospecnet" | "pointsea"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and sizes (config_pcn.py / config_55.py). The paths are
    relative to the working directory, as in the reference."""

    name: str = "ShapeNet"  # "ShapeNet" (PCN) | "ShapeNet55"; KITTI is ROADMAP queue A item 13
    category_file: str = "datasets/ShapeNet.json"
    n_renderings: int = 8  # partial scans per training model
    n_points: int = 2048  # points of a partial cloud
    partial_points_path: str = "./dataset/PCN/%s/partial/%s/%s/%02d.pcd"
    complete_points_path: str = "./dataset/PCN/%s/complete/%s/%s.pcd"
    gt_points: int = 16384  # points of a complete cloud (8192 on ShapeNet-55)
    mode: str = "easy"  # ShapeNet-55 evaluation crop: "easy" | "median" | "hard"
    num_workers: int = 4  # loader IO threads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation settings (config_pcn.py) and the run's switches."""

    batch_size: int = 12
    n_epochs: int = 400
    save_freq: int = 50  # ckpt-epoch-NNN every save_freq epochs
    learning_rate: float = 1e-4
    # MultiStep epochs (PCN), or the step size of StepLR in epochs (ShapeNet-55).
    lr_decay_step: Union[Sequence[int], int] = (40, 80, 120, 160, 200, 240, 280, 320, 360)
    warmup_steps: int = 300
    gamma: float = 0.7
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    sqrt_loss: bool = True  # chamfer_sqrt (CD-L1-style) pyramid loss; squared on ShapeNet-55
    partial_matching: bool = False  # get_loss_pm's one-way partial term (ShapeNet-55)
    # The optional adversarial branch of the ShapeNet-55 track (config_55.py).
    adv_enabled: bool = False
    adv_lambda_g: float = 0.05
    adv_d_lr: float = 1e-4
    adv_d_steps: int = 1
    gan_weight: float = 0.05  # GeoSpecNet's GAN term in the generator's loss
    # "f32" (reference-faithful) or "bf16": bf16 image trunk and flash
    # attention inputs, parameters and optimizer f32 (nn/precision.py).
    precision: str = "f32"
    progress: bool = False  # live per-batch loss line on stderr
    # Not ported yet; train_net refuses any other value (ROADMAP queue A).
    sp: int = 1  # sequence parallelism (item 15)
    dp: str = "gspmd"  # "shard_map" data parallelism (item 15)


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


def shapenet55_config(mode: str = "easy", adv: bool = False) -> Config:
    """SVDFormer on ShapeNet-55 (config_55.py): 8,192-point complete clouds,
    partials cropped online, the attention decoder, AdamW (wd 5e-4) with
    StepLR, the squared pyramid loss plus partial matching. ``mode`` is the
    evaluation crop; ``adv`` turns on the adversarial branch."""
    return Config(
        network=NetworkConfig(step1=2, step2=4, merge_points=1024, local_points=1024,
                              view_distance=1.5, decoder="attn"),
        data=DataConfig(name="ShapeNet55", category_file="datasets/ShapeNet55",
                        complete_points_path="./shapenet_pc/%s", gt_points=8192, mode=mode),
        train=TrainConfig(batch_size=16, n_epochs=300, save_freq=5, lr_decay_step=2, gamma=0.98,
                          weight_decay=5e-4, sqrt_loss=False, partial_matching=True,
                          adv_enabled=adv),
        out_path="out/svdformer_55",
    )


def shapenet34_config(unseen: bool = False, mode: str = "easy", adv: bool = False) -> Config:
    """The 55 track on ShapeNet-34, or with ``unseen`` its Unseen-21 test
    split: only the index directory differs (the reference's README)."""
    cfg = shapenet55_config(mode=mode, adv=adv)
    index = "datasets/ShapeNet-Unseen21" if unseen else "datasets/ShapeNet34"
    return cfg.replace(data=dataclasses.replace(cfg.data, category_file=index),
                       out_path="out/svdformer_34")


def geospec_config() -> Config:
    """GeoSpecNet with its discriminator on PCN data (config_geospec.py): the
    PCN sizes, schedule and Adam for both networks, ``get_loss_pm`` with the
    sqrt pyramid, GAN weight 0.05."""
    return Config(network=NetworkConfig(model="geospecnet"),
                  train=TrainConfig(sqrt_loss=True, partial_matching=True),
                  out_path="out/geospecnet_pcn")


def pointsea_config() -> Config:
    """PointSea on PCN data: the PCN sizes, schedule, Adam and sqrt pyramid
    loss, with the realistic voxel renderer that ``render.make_renderer``
    picks for the model."""
    return Config(network=NetworkConfig(model="pointsea"), out_path="out/pointsea_pcn")
