"""The configuration fields the PCN evaluation path reads
(values of svdformer_pointsea_tpu/configs/base.py)."""

from __future__ import annotations

import dataclasses


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
class Config:
    network: NetworkConfig = NetworkConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def pcn_config() -> Config:
    """SVDFormer on PCN (config_pcn.py)."""
    return Config()
