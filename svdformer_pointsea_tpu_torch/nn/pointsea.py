"""PointSea: SVDFormer with a ResNet-18 image encoder on realistic voxel
renders, two-stage view fusion and gated path-selection SDG refiners
(semantics of svdformer_pointsea_tpu/nn/pointsea.py).

Each image's 49 trunk tokens are paired with the point feature of its own
sample, as the JAX package pairs them (the original code tiles the point
features view-major, which mixes samples at batch > 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import (
    CrossAttentionBlock,
    EdgeConv,
    MLPConv,
    PointSeaSDGDecoder,
    SelfAttentionBlock,
    SinusoidalPositionalEmbedding,
)
from svdformer_pointsea_tpu_torch.nn.resnet import ResNet18
from svdformer_pointsea_tpu_torch.nn.svdformer import (
    FeatureExtractor,
    SeedGenerator,
    torch_channel_reshape,
)
from svdformer_pointsea_tpu_torch.ops import furthest_point_sample, gather_points, nn_squared_distance

LOCAL_CHANNELS = 64 + 256 + 512  # PointSeaLocalEncoder's concatenation


class PointSeaSDG(nn.Module):
    """SDG with path selection, upsampling by ``ratio``: the self path (sa1,
    decoder1) and the local path (cross1 against the local features,
    decoder2) are mixed by a sigmoid gate on [F_Q_ + F_H_, prev_f_l?,
    max-pooled F_Q, g]; ``use_prev`` (the second stage) conditions the gate on
    the previous stage's upsampled features too. forward(...) -> (fine (B,
    N * ratio, 3), f_l (B, N * ratio, channel))."""

    def __init__(self, ratio: int, hidden_dim: int = 768, channel: int = 128,
                 use_prev: bool = False, sigma: float = 0.2):
        super().__init__()
        ch = self.channel = channel
        self.ratio, self.hidden_dim, self.sigma, self.use_prev = ratio, hidden_dim, sigma, use_prev
        self.conv_x = nn.Linear(3, 64)
        self.conv_x1 = nn.Linear(64, ch)
        self.conv_11 = nn.Linear(512, 256)
        self.conv_1 = nn.Linear(256, ch)
        self.embedding = SinusoidalPositionalEmbedding(hidden_dim)
        self.sa1 = SelfAttentionBlock(ch * 2, hidden_dim, nhead=8)
        self.decoder1 = PointSeaSDGDecoder(hidden_dim)
        self.mlpp = MLPConv(LOCAL_CHANNELS, (hidden_dim,))
        self.cross1 = CrossAttentionBlock(hidden_dim, hidden_dim, nhead=8)
        self.decoder2 = PointSeaSDGDecoder(hidden_dim)
        gate_in = 2 * hidden_dim + ch + (ch if use_prev else 0)
        self.fusionMlp = MLPConv(gate_in, (hidden_dim,))
        self.conv_ps = nn.Linear(hidden_dim, ch * ratio)
        self.conv_delta = nn.Linear(ch, ch)
        self.conv_out1 = nn.Linear(ch, 64)
        self.conv_out = nn.Linear(64, 3)

    def forward(self, local_feat: torch.Tensor, coarse: torch.Tensor, f_g: torch.Tensor,
                partial: torch.Tensor, prev_f_l: Optional[torch.Tensor] = None):
        B, N, _ = coarse.shape
        ch, hidden, ratio = self.channel, self.hidden_dim, self.ratio
        feat = self.conv_x1(F.gelu(self.conv_x(coarse)))
        g = self.conv_1(F.gelu(self.conv_11(f_g)))
        feat = torch.cat([feat, g.expand(B, N, ch)], dim=-1)

        # The NN distance feeds only the embedding, which detaches it.
        half_cd = nn_squared_distance(coarse, partial) / self.sigma
        pos = self.embedding(half_cd).reshape(B, hidden, N).transpose(1, 2)

        f_q = self.sa1(feat, pos=pos)
        f_q_ = self.decoder1(f_q)
        f_g_current = f_q.amax(dim=1, keepdim=True)  # sa1's output, not decoder1's
        f_h = self.cross1(f_q, self.mlpp(local_feat))
        f_h_ = self.decoder2(f_h)

        gate_in = [f_q_ + f_h_, f_g_current.expand(B, N, hidden), g.expand(B, N, ch)]
        if self.use_prev:
            gate_in.insert(1, prev_f_l)
        score = torch.sigmoid(self.fusionMlp(torch.cat(gate_in, dim=-1)))
        f_l = score * f_q_ + (1 - score) * f_h_

        f_l = torch_channel_reshape(self.conv_ps(f_l), ch, N * ratio)
        f_l = self.conv_delta(f_l)
        o_l = self.conv_out(F.gelu(self.conv_out1(f_l)))
        return coarse.repeat(1, ratio, 1) + o_l, f_l


class PointSeaSVFNet(SeedGenerator):
    """Two-stage view fusion encoder: points (B, N, 3), realistic renders
    (B * 3, 3, H, W) -> f_g (B, 1, 512), coarse (B, 256, 3). Stage 1 attends
    over each image's ResNet-18 tokens joined to its sample's point feature
    and max-pools them; stage 2 attends over the 3 views with the camera
    embedding as the position and max-pools them."""

    def __init__(self, view_distance: float, channel: int = 64):
        super().__init__()
        self.img_trunk = ResNet18()
        self.point_fe = FeatureExtractor(use_pcsa=False)
        d = view_distance
        self.register_buffer(
            "view_point", torch.tensor([[0.0, 0.0, -d], [-d, 0.0, 0.0], [0.0, d, 0.0]]),
            persistent=False)
        self.posmlp = MLPConv(3, (64, 256))
        self.viewattn1 = SelfAttentionBlock(768, 512)
        self.viewattn2 = SelfAttentionBlock(768, 256)
        self.add_seed_layers(channel)

    def forward(self, points: torch.Tensor, depth: torch.Tensor):
        B = points.shape[0]
        V = depth.shape[0] // B
        f_v = self.img_trunk(depth).flatten(2).transpose(1, 2)  # (B*V, h*w, 512), token y*w + x
        f_p = self.point_fe(points)  # (B, 1, 256)
        view_feature = self.posmlp(self.view_point.expand(B, 3, 3))  # (B, 3, 256)

        fused = torch.cat([f_v, f_p.repeat_interleave(V, dim=0).expand(-1, f_v.shape[1], -1)],
                          dim=-1)  # (B*V, h*w, 768)
        f_v_ = self.viewattn1(fused).reshape(B, V, f_v.shape[1], -1).amax(dim=2)  # (B, V, 512)
        fused2 = torch.cat([f_v_, f_p.expand(B, V, f_p.shape[-1])], dim=-1)  # (B, V, 768)
        f_v_ = self.viewattn2(fused2, pos=view_feature).amax(dim=1, keepdim=True)
        f_g = torch.cat([f_p, f_v_], dim=-1)  # (B, 1, 512)
        return f_g, self.seed_points(f_g)


class PointSeaLocalEncoder(nn.Module):
    """Three EdgeConv levels: (B, N, 3) -> (B, local_points, 64 + 256 + 512),
    the first level FPS-sampled to ``local_points`` before the next two."""

    def __init__(self, local_points: int = 512):
        super().__init__()
        self.local_points = local_points
        self.gcn1 = EdgeConv(3, 64, 16)
        self.gcn2 = EdgeConv(64, 256, 8)
        self.gcn3 = EdgeConv(256, 512, 4)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x1 = self.gcn1(points)
        x1 = gather_points(x1, furthest_point_sample(points, self.local_points))
        x2 = self.gcn2(x1)
        x3 = self.gcn3(x2)
        return torch.cat([x1, x2, x3], dim=-1)


class PointSea(nn.Module):
    """forward(partial (B, N, 3), renders (B * 3, 3, H, W)) -> (coarse (B, 256,
    3), fine1 (B, merge * step1, 3), fine2 (B, merge * step1 * step2, 3))."""

    def __init__(self, step1: int = 4, step2: int = 8, merge_points: int = 512,
                 local_points: int = 512, view_distance: float = 0.7):
        super().__init__()
        self.merge_points = merge_points
        self.encoder = PointSeaSVFNet(view_distance)
        self.localencoder = PointSeaLocalEncoder(local_points)
        self.refine1 = PointSeaSDG(step1, hidden_dim=768)
        self.refine2 = PointSeaSDG(step2, hidden_dim=512, use_prev=True)

    @classmethod
    def from_config(cls, net) -> "PointSea":
        """Build from a ``configs.NetworkConfig``."""
        return cls(step1=net.step1, step2=net.step2, merge_points=net.merge_points,
                   local_points=net.local_points, view_distance=net.view_distance)

    def forward(self, partial: torch.Tensor, depth: torch.Tensor):
        feat_g, coarse = self.encoder(partial, depth)
        local_feat = self.localencoder(partial)
        merged = torch.cat([partial, coarse], dim=1)
        coarse_merge = gather_points(merged, furthest_point_sample(merged, self.merge_points))
        fine1, f_l1 = self.refine1(local_feat, coarse_merge, feat_g, partial)
        fine2, _ = self.refine2(local_feat, fine1, feat_g, partial, prev_f_l=f_l1)
        return coarse, fine1, fine2
