"""GeoSpecNet: SVDFormer with a spectral point encoder (semantics of
svdformer_pointsea_tpu/nn/geospecnet.py ``SpectralAdapter``, ``MSGSpecConv``,
``SpectralFeatureExtractor``, ``SVFNetGS`` and ``GeoSpecNet``).

The encoder's point branch filters each kNN patch of the 128 mid-scale
points in an orthonormal DCT basis with a learned gate per channel and
frequency, pools the filtered neighbours by a softmax over their geometry,
and adds the result to the SA features. The rest of the generator is
SVDFormer's: its image trunk and fusion, ``LocalEncoder``, merge FPS and
both SDG stages.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import PointNetSAModuleKNN, dct_matrix
from svdformer_pointsea_tpu_torch.nn.svdformer import SVDFormer, SVFNet
from svdformer_pointsea_tpu_torch.ops import group_local, index_points


class SpectralAdapter(nn.Module):
    """xyz (B, N, 3), feats (B, N, C) -> (B, N, out_channels): each point's
    ``k`` nearest neighbours (self included) as a patch of features, taken to
    the DCT basis (X · Dᵀ), gated per channel and frequency by ``freq_gate``
    (C, k), taken back (· D), summed with softmax(−a) weights over the patch,
    then a two-layer projection (hidden max(C / reduction, 16)). a comes from
    ``geo_fc1`` / ``geo_fc2`` on the norms of the neighbours' absolute
    coordinates, as the reference computes them."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 16, reduction: int = 4):
        super().__init__()
        self.k = k
        self.register_buffer("dct", torch.from_numpy(dct_matrix(k)), persistent=False)
        self.geo_fc1 = nn.Linear(1, 16)
        self.geo_fc2 = nn.Linear(16, 1)
        self.freq_gate = nn.Parameter(torch.zeros(in_channels, k))  # drawn by init_parameters
        hidden = max(in_channels // reduction, 16)
        self.proj_fc1 = nn.Linear(in_channels, hidden)
        self.proj_fc2 = nn.Linear(hidden, out_channels)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        group_xyz, idx = group_local(xyz, k=self.k, return_idx=True)
        neigh = index_points(feats, idx)  # (B, N, K, C)
        dists = torch.linalg.norm(group_xyz, dim=-1, keepdim=True)  # (B, N, K, 1)
        a = self.geo_fc2(F.relu(self.geo_fc1(dists)))
        attn = torch.softmax(-a[..., 0], dim=-1)[..., None]
        spec = torch.einsum("bnkc,fk->bnfc", neigh, self.dct) * self.freq_gate.t()
        filt = torch.einsum("bnfc,fk->bnkc", spec, self.dct)
        out = (filt * attn).sum(dim=2)
        return self.proj_fc2(F.relu(self.proj_fc1(out)))


class MSGSpecConv(nn.Module):
    """One :class:`SpectralAdapter` per K of ``k_list`` (``branch0``,
    ``branch1`` ...), concatenated, then ``fuse`` and a ReLU."""

    def __init__(self, in_channels: int, out_channels: int, k_list: Sequence[int] = (16, 32)):
        super().__init__()
        self.n = len(k_list)
        for i, k in enumerate(k_list):
            self.add_module(f"branch{i}", SpectralAdapter(in_channels, out_channels, k))
        self.fuse = nn.Linear(out_channels * self.n, out_channels)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        out = torch.cat([getattr(self, f"branch{i}")(xyz, feats) for i in range(self.n)], dim=-1)
        return F.relu(self.fuse(out))


class SpectralFeatureExtractor(nn.Module):
    """Points (B, N, 3) -> global feature (B, 1, out_dim): SA 512 / 16 and
    128 / 16 without BatchNorm or PCSA, the spectral residual at the 128
    points, and the group-all SA."""

    def __init__(self, out_dim: int = 256):
        super().__init__()
        self.sa1 = PointNetSAModuleKNN(512, 16, 3, (64, 128), if_bn=False, if_idx=True)
        self.sa2 = PointNetSAModuleKNN(128, 16, 128, (128, 256), if_bn=False, if_idx=True)
        self.msg_spec = MSGSpecConv(256, 256)
        self.sa3 = PointNetSAModuleKNN(None, None, 256, (512, out_dim), if_bn=False,
                                       group_all=True)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        l1_xyz, l1_points, _ = self.sa1(points, points)
        l2_xyz, l2_points, _ = self.sa2(l1_xyz, l1_points)
        l2_points = l2_points + self.msg_spec(l2_xyz, l2_points)
        return self.sa3(l2_xyz, l2_points)[1]


class SVFNetGS(SVFNet):
    """:class:`SVFNet` with the spectral point encoder."""

    def __init__(self, view_distance: float, channel: int = 64):
        super().__init__(view_distance, channel, point_fe=SpectralFeatureExtractor())


class GeoSpecNet(SVDFormer):
    """The GeoSpecNet generator: :class:`SVDFormer` with the
    :class:`SVFNetGS` encoder (same forward and outputs)."""

    def __init__(self, step1: int = 4, step2: int = 8, merge_points: int = 512,
                 local_points: int = 512, view_distance: float = 0.7, decoder: str = "sdg"):
        super().__init__(step1, step2, merge_points, local_points, view_distance, decoder,
                         encoder=SVFNetGS(view_distance))
