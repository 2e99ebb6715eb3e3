"""Configurations."""

from svdformer_pointsea_tpu_torch.configs.base import (
    Config,
    DataConfig,
    NetworkConfig,
    TrainConfig,
    geospec_config,
    kitti_config,
    pcn_config,
    pointsea_config,
    shapenet34_config,
    shapenet55_config,
)

__all__ = ["Config", "DataConfig", "NetworkConfig", "TrainConfig", "geospec_config", "kitti_config",
           "pcn_config", "pointsea_config", "shapenet34_config", "shapenet55_config"]
