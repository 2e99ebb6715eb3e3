"""Configurations."""

from svdformer_pointsea_tpu_torch.configs.base import Config, NetworkConfig, pcn_config

__all__ = ["Config", "NetworkConfig", "pcn_config"]
