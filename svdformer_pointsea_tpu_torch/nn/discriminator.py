"""The point-set discriminators: the ShapeNet-55 track's adversarial branch's
and GeoSpecNet's (semantics of svdformer_pointsea_tpu/nn/geospecnet.py
``SimplePointDiscriminator`` and ``PointDiscriminator``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm


class SimplePointDiscriminator(nn.Module):
    """pcd (B, N, 3) -> logits (B, 1): a shared per-point MLP of three
    layers (LeakyReLU 0.2 after the first two, no norm), a max over the
    points, and a two-layer head."""

    def __init__(self, hidden: int = 128):
        super().__init__()
        self.mlp0 = nn.Linear(3, hidden)
        self.mlp1 = nn.Linear(hidden, hidden)
        self.mlp2 = nn.Linear(hidden, hidden)
        self.head0 = nn.Linear(hidden, hidden)
        self.head1 = nn.Linear(hidden, 1)

    def forward(self, pcd: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.mlp0(pcd), 0.2)
        x = self.mlp2(F.leaky_relu(self.mlp1(x), 0.2))
        g = F.leaky_relu(self.head0(x.amax(dim=1)), 0.2)
        return self.head1(g)


class PointDiscriminator(nn.Module):
    """GeoSpecNet's discriminator, pcd (B, N, 3) -> logits (B,): a per-point
    stem of 64, 128 and ``feat_size`` channels, each Linear followed by
    :class:`BatchNorm` (batch moments with the row weights in train mode,
    running statistics in eval mode) and a ReLU, a max over the points, and
    a two-layer head."""

    def __init__(self, feat_size: int = 256):
        super().__init__()
        c_in = 3
        for i, f in enumerate((64, 128, feat_size)):
            self.add_module(f"stem{i}", nn.Linear(c_in, f))
            self.add_module(f"bn{i}", BatchNorm(f))
            c_in = f
        self.head0 = nn.Linear(feat_size, feat_size // 2)
        self.head1 = nn.Linear(feat_size // 2, 1)

    def forward(self, pcd: torch.Tensor) -> torch.Tensor:
        x = pcd
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"stem{i}")(x)))
        return self.head1(F.relu(self.head0(x.amax(dim=1))))[:, 0]
