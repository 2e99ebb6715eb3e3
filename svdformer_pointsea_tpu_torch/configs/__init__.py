"""Configurations."""

from svdformer_pointsea_tpu_torch.configs.base import (
    Config,
    DataConfig,
    NetworkConfig,
    TrainConfig,
    pcn_config,
)

__all__ = ["Config", "DataConfig", "NetworkConfig", "TrainConfig", "pcn_config"]
