"""The point-set discriminator of the ShapeNet-55 track's adversarial branch
(semantics of svdformer_pointsea_tpu/nn/geospecnet.py
``SimplePointDiscriminator``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
