"""SVDFormer: self-view fusion encoder + two self-structure dual generators.

Mirrors svdformer_pointsea_tpu/nn/svdformer.py in channels-last layout. The
reference's channel-first ``reshape`` calls reinterpret memory rather than
transpose; ``torch_channel_reshape`` reproduces those element mappings (seed
unfold, point shuffle), and the positional embedding and the ``ps`` seed
layer reproduce theirs inline.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import (
    BatchNorm,
    CrossAttentionBlock,
    EdgeConv,
    MLPConv,
    PointNetSAModuleKNN,
    SDGDecoder,
    SelfAttentionBlock,
    SinusoidalPositionalEmbedding,
)
from svdformer_pointsea_tpu_torch.nn.resnet import ImageTrunk
from svdformer_pointsea_tpu_torch.ops import furthest_point_sample, gather_points, nn_squared_distance


def torch_channel_reshape(x_cl: torch.Tensor, new_c: int, new_n: int) -> torch.Tensor:
    """``reshape(B, new_c, new_n)`` of the channels-first view of ``x_cl``
    (B, N, C), returned channels-last: (B, new_n, new_c)."""
    return x_cl.transpose(1, 2).reshape(x_cl.shape[0], new_c, new_n).transpose(1, 2)


class FeatureExtractor(nn.Module):
    """Three SA-kNN stages: points (B, N, 3) -> global feature (B, 1, out_dim);
    ``use_pcsa`` runs PCSA in the first two (SVDFormer's; PointSea's has none)."""

    def __init__(self, out_dim: int = 256, use_pcsa: bool = True):
        super().__init__()
        self.sa1 = PointNetSAModuleKNN(512, 16, 3, (64, 128), if_bn=False, if_idx=True,
                                       use_pcsa=use_pcsa)
        self.sa2 = PointNetSAModuleKNN(128, 16, 128, (128, 256), if_bn=False, if_idx=True,
                                       use_pcsa=use_pcsa)
        self.sa3 = PointNetSAModuleKNN(None, None, 256, (512, out_dim), if_bn=False,
                                       group_all=True)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        l1_xyz, l1_points, _ = self.sa1(points, points)
        l2_xyz, l2_points, _ = self.sa2(l1_xyz, l1_points)
        return self.sa3(l2_xyz, l2_points)[1]


class SeedGenerator(nn.Module):
    """The coarse seed generator of :class:`SVFNet` and PointSea's encoder:
    the global feature f_g (B, 1, 512) -> coarse points (B, 256, 3). A
    subclass registers the layers with :meth:`add_seed_layers` after its own."""

    def add_seed_layers(self, channel: int) -> None:
        c = self.channel = channel
        # ConvTranspose1d(512 -> c, k=128) on a length-1 input: one Linear to
        # c * 128 outputs laid out channel-major, with a bias per output (the
        # JAX tree keeps all c * 128 bias values).
        self.ps = nn.Linear(512, c * 128)
        self.ps_refuse = nn.Linear(c + 512, c * 8)
        self.sa = SelfAttentionBlock(c * 8, c * 8)
        self.conv_out1 = nn.Linear(c * 4 + 512, 64)
        self.conv_out = nn.Linear(64, 3)

    def seed_points(self, f_g: torch.Tensor) -> torch.Tensor:
        B, c = f_g.shape[0], self.channel
        x = F.gelu(self.ps(f_g[:, 0]).reshape(B, c, 128).transpose(1, 2))  # (B, 128, c)
        x = torch.cat([x, f_g.expand(B, 128, 512)], dim=-1)
        x2 = self.sa(F.gelu(self.ps_refuse(x)))  # (B, 128, 8c)
        # 128 seed tokens x 8c channels unfold to 256 points x 4c channels.
        n_coarse = (128 * c * 8) // (c * 4)
        x2_d = torch_channel_reshape(x2, c * 4, n_coarse)
        h = torch.cat([x2_d, f_g.expand(B, n_coarse, 512)], dim=-1)
        return self.conv_out(F.gelu(self.conv_out1(h)))


class SVFNet(SeedGenerator):
    """Self-view fusion encoder and coarse seed generator:
    points (B, N, 3), depth (B, 3, H, W) -> f_g (B, 1, 512), coarse (B, 256, 3).
    ``point_fe`` is the point encoder, (B, N, 3) -> (B, 1, 256) (default
    :class:`FeatureExtractor`; GeoSpecNet's is spectral)."""

    def __init__(self, view_distance: float, channel: int = 64,
                 point_fe: Optional[nn.Module] = None):
        super().__init__()
        self.img_trunk = ImageTrunk(feat_size=16)
        self.point_fe = FeatureExtractor() if point_fe is None else point_fe
        d = view_distance
        self.register_buffer(
            "view_point", torch.tensor([[0.0, 0.0, -d], [-d, 0.0, 0.0], [0.0, d, 0.0]]),
            persistent=False)
        self.posmlp = MLPConv(3, (64, 256))
        self.viewattn = SelfAttentionBlock(384, 256)
        self.add_seed_layers(channel)

    def forward(self, points: torch.Tensor, depth: torch.Tensor):
        B = points.shape[0]
        V = depth.shape[1]
        f_v = self.img_trunk(depth.reshape(B * V, 1, depth.shape[2], depth.shape[3]))
        f_v = f_v.reshape(B, V, -1)  # (B, 3, 128), batch-major view-minor
        f_p = self.point_fe(points)  # (B, 1, 256)
        view_feature = self.posmlp(self.view_point.expand(B, 3, 3))  # (B, 3, 256)
        fused = torch.cat([f_v, f_p.expand(B, V, f_p.shape[-1])], dim=-1)  # (B, 3, 384)
        f_v_ = self.viewattn(fused, pos=view_feature).amax(dim=1, keepdim=True)
        f_g = torch.cat([f_p, f_v_], dim=-1)  # (B, 1, 512)
        return f_g, self.seed_points(f_g)


def _decoder(kind: str, hidden_dim: int, out_dim: int, ratio: int) -> nn.Module:
    """An SDG decoder: two stacked attention blocks (``"sdg"``, PCN) or one
    (``"attn"``, ShapeNet-55), hidden -> ``out_dim`` * ``ratio`` channels."""
    if kind == "sdg":
        return SDGDecoder(hidden_dim, out_dim, ratio)
    if kind == "attn":
        return SelfAttentionBlock(hidden_dim, out_dim * ratio, nhead=8)
    raise ValueError(f"decoder must be sdg or attn, got {kind!r}")


class SDG(nn.Module):
    """Self-structure dual-generator refinement, upsampling by ``ratio``;
    ``decoder`` picks the decoders of both paths (:func:`_decoder`)."""

    def __init__(self, ratio: int, hidden_dim: int = 512, channel: int = 128,
                 sigma: float = 0.2, decoder: str = "sdg"):
        super().__init__()
        ch = self.channel = channel
        self.ratio, self.hidden_dim, self.sigma = ratio, hidden_dim, sigma
        self.conv_x = nn.Linear(3, 64)
        self.conv_x1 = nn.Linear(64, ch)
        self.conv_11 = nn.Linear(512, 256)
        self.conv_1 = nn.Linear(256, ch)
        self.embedding = SinusoidalPositionalEmbedding(hidden_dim)
        self.sa1 = SelfAttentionBlock(ch * 2, hidden_dim, nhead=8)
        self.decoder1 = _decoder(decoder, hidden_dim, ch, ratio)
        self.decoder2 = _decoder(decoder, hidden_dim, ch, ratio)
        self.mlpp = MLPConv(256, (256, hidden_dim))
        self.cross1 = CrossAttentionBlock(hidden_dim, hidden_dim, nhead=8)
        self.conv_ps = nn.Linear(ch * ratio * 2, ch * ratio)
        self.conv_delta = nn.Linear(ch, ch)
        self.conv_out1 = nn.Linear(ch, 64)
        self.conv_out = nn.Linear(64, 3)

    def forward(self, local_feat, coarse, f_g, partial):
        B, N, _ = coarse.shape
        ch, hidden, ratio = self.channel, self.hidden_dim, self.ratio
        feat = self.conv_x1(F.gelu(self.conv_x(coarse)))
        g = self.conv_1(F.gelu(self.conv_11(f_g)))
        feat = torch.cat([feat, g.expand(B, N, ch)], dim=-1)

        # Structure analysis: NN distance to the partial input, embedded; the
        # reference reinterprets the (B, N, hidden) embedding as (B, hidden, N).
        half_cd = nn_squared_distance(coarse, partial) / self.sigma
        emb = self.embedding(half_cd)
        pos = emb.reshape(B, hidden, N).transpose(1, 2)

        f_q = self.sa1(feat, pos=pos)
        f_q_ = self.decoder1(f_q)
        # Similarity alignment against the local features.
        f_h = self.cross1(f_q, self.mlpp(local_feat))
        f_h_ = self.decoder2(f_h)

        # Point-shuffle upsample (channel-major unfold) + coordinate offsets.
        f_l = self.conv_ps(torch.cat([f_q_, f_h_], dim=-1))
        f_l = self.conv_delta(torch_channel_reshape(f_l, ch, N * ratio))
        o_l = self.conv_out(F.gelu(self.conv_out1(f_l)))
        return coarse.repeat(1, ratio, 1) + o_l


class LocalEncoder(nn.Module):
    """EdgeConv local feature pyramid: (B, N, 3) -> (B, local_points, 256)."""

    def __init__(self, local_points: int = 512):
        super().__init__()
        self.local_points = local_points
        self.gcn1 = EdgeConv(3, 64, 16)
        self.gcn2 = EdgeConv(64, 256, 8)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x1 = self.gcn1(points)
        x1 = gather_points(x1, furthest_point_sample(points, self.local_points))
        return self.gcn2(x1)


class SVDFormer(nn.Module):
    """forward(partial (B, N, 3), depth (B, 3, H, W)) -> (coarse (B, 256, 3),
    fine1 (B, merge * step1, 3), fine2 (B, merge * step1 * step2, 3)).
    ``decoder`` is "sdg" (PCN) or "attn" (ShapeNet-55); ``encoder`` replaces
    the :class:`SVFNet` encoder (GeoSpecNet's)."""

    def __init__(self, step1: int = 4, step2: int = 8, merge_points: int = 512,
                 local_points: int = 512, view_distance: float = 0.7, decoder: str = "sdg",
                 encoder: Optional[nn.Module] = None):
        super().__init__()
        self.merge_points = merge_points
        self.encoder = SVFNet(view_distance) if encoder is None else encoder
        self.localencoder = LocalEncoder(local_points)
        self.refine1 = SDG(step1, hidden_dim=768, decoder=decoder)
        self.refine2 = SDG(step2, hidden_dim=512, decoder=decoder)

    @classmethod
    def from_config(cls, net) -> "SVDFormer":
        """Build from a ``configs.NetworkConfig``."""
        return cls(step1=net.step1, step2=net.step2, merge_points=net.merge_points,
                   local_points=net.local_points, view_distance=net.view_distance,
                   decoder=net.decoder)

    def forward(self, partial: torch.Tensor, depth: torch.Tensor):
        feat_g, coarse = self.encoder(partial, depth)
        local_feat = self.localencoder(partial)
        merged = torch.cat([partial, coarse], dim=1)
        coarse_merge = gather_points(merged, furthest_point_sample(merged, self.merge_points))
        fine1 = self.refine1(local_feat, coarse_merge, feat_g, partial)
        fine2 = self.refine2(local_feat, fine1, feat_g, partial)
        return coarse, fine1, fine2


_ZERO_GRADIENT = {
    # SVDFormer and GeoSpecNet (and PointDiscriminator's stems): gcn1's output
    # enters only gcn2's conv0.
    "svdformer": re.compile(
        r".*attn\.k_proj\.bias|localencoder\.(gcn\d\.conv[01]|gcn1\.conv2)\.bias"
        r"|.*\.geo_fc2\.bias|stem\d\.bias"),
    # PointSea: gcn1's output also enters the local features (mlpp).
    "pointsea": re.compile(r".*attn\.k_proj\.bias|localencoder\.gcn\d\.conv[01]\.bias"),
}
_ZERO_GRADIENT["geospecnet"] = _ZERO_GRADIENT["svdformer"]


def has_zero_gradient(name: str, model: str = "svdformer") -> bool:
    """True for the parameters of the ``model`` family (a ``cfg.network.model``:
    SVDFormer, GeoSpecNet with PointDiscriminator, or PointSea) whose exact
    gradient is 0, so that their computed gradient is rounding noise: every
    attention key-projection bias and each SpectralAdapter's ``geo_fc2`` bias
    (a softmax removes a per-row constant), and each bias that reaches a
    BatchNorm through linear maps only (EdgeConv's conv0 / conv1; in
    SVDFormer and GeoSpecNet also gcn1's conv2, whose output enters only
    gcn2's conv0; the discriminator's stem layers; all in train mode:
    BatchNorm removes a per-channel constant). Adam scales that noise up to
    steps of up to lr."""
    return _ZERO_GRADIENT[model].fullmatch(name) is not None


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight from ``generator`` (on the CPU, so one seed gives one
    model on any device): Linear / Conv weights and biases uniform in
    ±1/sqrt(fan_in), norm scales 1 and shifts 0, BatchNorm running stats
    mean 0 / var 1, a SpectralAdapter's ``freq_gate`` 0.02 N(0, 1)."""
    for m in model.modules():
        if isinstance(getattr(m, "freq_gate", None), nn.Parameter):
            m.freq_gate.copy_(0.02 * torch.randn(m.freq_gate.shape, generator=generator))
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
        elif isinstance(m, (nn.LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
