"""Shared building blocks (channels-last ``(B, N, C)``).

Mirrors svdformer_pointsea_tpu/nn/layers.py. Attribute names follow the JAX
parameter tree (``layer0``, ``norm13``, ``attn.q_proj`` ...), so a JAX tree
maps onto a ``state_dict`` leaf by leaf (``train/convert.py``). Every
LayerNorm uses flax's eps 1e-6 and every GELU is the exact (erf) one.
BatchNorm normalises with its running statistics in eval mode and with
weighted batch moments in train mode (rows weighted by :func:`bn_row_weights`).

Attention goes through :func:`scaled_attention`, which sends CUDA inputs with
at least 512 query tokens, both lengths multiples of 512 and a head dim of
64, 96, 128 or 256 to the flash kernels (``nn/flash.py``), as the JAX package
sends them to its Pallas flash kernels, and everything else to the naive math
(in bf16 mode with bf16 q, k and v, ``nn/precision.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.flash import (
    FLASH_HEAD_DIMS,
    flash_attention,
    flash_attention_train,
    naive_attention,
)
from svdformer_pointsea_tpu_torch.nn.precision import mixed_precision_enabled
from svdformer_pointsea_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_local,
    grouping_operation,
    sample_and_group_all,
    sample_and_group_ball,
    sample_and_group_knn,
    three_interpolate,
    three_nn,
)

LN_EPS = 1e-6  # flax.linen.LayerNorm default
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax EMA decay of the running statistics (torch momentum 0.1)

# (B,) row weights of the train step's batch (0 for pad rows); None = all 1.
_BN_ROW_WEIGHTS: Optional[torch.Tensor] = None


@contextlib.contextmanager
def bn_row_weights(weights: Optional[torch.Tensor]) -> Iterator[None]:
    """Scope the (B,) row weights of a train step into every train-mode
    :class:`BatchNorm`: a row of weight 0 adds nothing to the batch moments
    (nn/layers.py::bn_row_weights of the JAX package)."""
    global _BN_ROW_WEIGHTS
    prev = _BN_ROW_WEIGHTS
    _BN_ROW_WEIGHTS = weights
    try:
        yield
    finally:
        _BN_ROW_WEIGHTS = prev


class BatchNorm(nn.Module):
    """BatchNorm over channel axis ``dim``, computed as flax does.

    Eval mode: (x - mean) * (rsqrt(var + eps) * weight) + bias on the running
    statistics. Train mode (the JAX package's ``_WeightedBatchNorm``): with
    row weights w, each covering k = len(x) / len(w) consecutive rows (the
    image trunk folds B samples x 3 views batch-major), s0 = Σw·n_spatial,
    s1 = Σw·x, s2 = Σw·x²; mean = s1 / s0 and the biased "fast" variance
    s2 / s0 - mean². The output is x * mul + (bias - mean * mul), mul =
    rsqrt(var + eps) * weight, and the running statistics move as
    ra <- 0.9 ra + 0.1 batch, with the biased variance. A bf16 input (the
    image trunk in bf16 mode) takes its batch moments in f32 from the upcast
    input and gets x * bf16(mul) + bf16(shift) in bf16, shift = bias - mean *
    mul, as the JAX package's BatchNorm with ``dtype=bf16``.
    """

    def __init__(self, num_features: int, dim: int = -1, eps: float = BN_EPS):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _batch_moments(self, x: torch.Tensor):
        w = _BN_ROW_WEIGHTS
        if w is None:
            w = torch.ones(x.shape[0], device=x.device)
        k, rem = divmod(x.shape[0], w.shape[0])
        if rem:
            raise ValueError(f"BatchNorm: {x.shape[0]} rows for {w.shape[0]} row weights")
        wf = w.to(torch.float32).repeat_interleave(k)
        dim = self.dim % x.dim()
        red = [d for d in range(x.dim()) if d != dim]
        wb = wf.view(-1, *([1] * (x.dim() - 1)))
        s0 = wf.sum() * (x[0].numel() // x.shape[dim])
        mean = (wb * x).sum(red) / s0
        var = (wb * x.square()).sum(red) / s0 - mean.square()
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.training:
            mean, var = self._batch_moments(x.float())
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        if x.dtype == torch.bfloat16:  # the image trunk in bf16 mode: a bf16 affine
            bf = torch.bfloat16
            return x * mul.to(bf).view(shape) + (self.bias - mean * mul).to(bf).view(shape)
        if not self.training:
            return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return x * mul.view(shape) + (self.bias - mean * mul).view(shape)


class MLPConv(nn.Module):
    """Linear stack, ReLU between layers, none after the last."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"layer{i}", nn.Linear(in_features, f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class SharedMLP(nn.Module):
    """Per-point Linear stack with optional BatchNorm + ReLU after each layer;
    the last layer stays linear unless ``last_act``."""

    def __init__(self, in_features: int, features: Sequence[int], if_bn: bool = True,
                 last_act: bool = True):
        super().__init__()
        self.n = len(features)
        self.if_bn = if_bn
        self.last_act = last_act
        for i, f in enumerate(features):
            self.add_module(f"layer{i}", nn.Linear(in_features, f))
            if if_bn and (i < self.n - 1 or last_act):
                self.add_module(f"bn{i}", BatchNorm(f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1 or self.last_act:
                if self.if_bn:
                    x = getattr(self, f"bn{i}")(x)
                x = F.relu(x)
        return x


_FLASH_MIN_Q = 512
_FLASH_BLOCK = 512


def _on_card(t: torch.Tensor) -> bool:
    """The flash path's device rule: a CUDA tensor (the JAX package's is the
    TPU backend). On the CPU, attention is the naive math, as off the TPU."""
    return t.device.type == "cuda"


def _flash_eligible(q: torch.Tensor, k: torch.Tensor) -> bool:
    # The device and the JAX package's shape rule, no dtype clause: an
    # eligible CUDA input of another dtype reaches the kernel wrapper, which
    # raises. reference_ops() is decided inside the flash functions, which
    # then run their plain versions of the same function.
    if not _on_card(q):
        return False
    qn, kn, dh = q.shape[1], k.shape[1], q.shape[-1]
    return (qn >= _FLASH_MIN_Q and qn % _FLASH_BLOCK == 0 and kn % _FLASH_BLOCK == 0
            and dh in FLASH_HEAD_DIMS)


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh)) v over (B, L, h, dh) tensors. Eligible shapes
    take K3 alone when no gradient is recorded, and K3 with its statistics
    plus K4 / K5 in the backward when one is; the rest the naive math. In
    bf16 mode an eligible site casts q, k, v to bf16 and the output back, so
    autograd carries a bf16 cotangent into the backward kernels."""
    if not _flash_eligible(q, k):
        return naive_attention(q, k, v)
    dtype = q.dtype
    if mixed_precision_enabled():
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_train(q, k, v).to(dtype)
    return flash_attention(q, k, v).to(dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        assert d_model % nhead == 0, (d_model, nhead)
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value):
        h = self.nhead

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], h, -1)

        out = scaled_attention(split(self.q_proj(query)), split(self.k_proj(key)),
                               split(self.v_proj(value)))
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class SelfAttentionBlock(nn.Module):
    """Pre-LN self-attention: q = k = LN(proj(x)) + pos, value = LN(proj(x)),
    then LN and a GELU feed-forward. (B, N, d_in) -> (B, N, d_out)."""

    def __init__(self, d_in: int, d_out: int, nhead: int = 4, dim_feedforward: int = 1024):
        super().__init__()
        self.input_proj = nn.Linear(d_in, d_out)
        self.norm13 = nn.LayerNorm(d_out, eps=LN_EPS)
        self.attn = MultiheadAttention(d_out, nhead)
        self.norm12 = nn.LayerNorm(d_out, eps=LN_EPS)
        self.linear11 = nn.Linear(d_out, dim_feedforward)
        self.linear12 = nn.Linear(dim_feedforward, d_out)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        src = self.norm13(self.input_proj(x))
        qk = src if pos is None else src + pos
        src = self.norm12(src + self.attn(qk, qk, src))
        return src + self.linear12(F.gelu(self.linear11(src)))


class CrossAttentionBlock(nn.Module):
    """Pre-LN cross-attention; one input projection and one norm13 serve both
    streams, as in the reference."""

    def __init__(self, d_in: int, d_out: int, nhead: int = 4, dim_feedforward: int = 1024):
        super().__init__()
        self.input_proj = nn.Linear(d_in, d_out)
        self.norm13 = nn.LayerNorm(d_out, eps=LN_EPS)
        self.attn = MultiheadAttention(d_out, nhead)
        self.norm12 = nn.LayerNorm(d_out, eps=LN_EPS)
        self.linear11 = nn.Linear(d_out, dim_feedforward)
        self.linear12 = nn.Linear(dim_feedforward, d_out)

    def forward(self, src1, src2, pos: Optional[torch.Tensor] = None):
        s1 = self.norm13(self.input_proj(src1))
        s2 = self.norm13(self.input_proj(src2))
        q = s1 if pos is None else s1 + pos
        s1 = self.norm12(s1 + self.attn(q, s2, s2))
        return s1 + self.linear12(F.gelu(self.linear11(s1)))


class SDGDecoder(nn.Module):
    """Two stacked self-attention blocks, hidden -> hidden -> channel * ratio."""

    def __init__(self, hidden_dim: int, channel: int, ratio: int):
        super().__init__()
        self.sa1 = SelfAttentionBlock(hidden_dim, hidden_dim, nhead=8)
        self.sa2 = SelfAttentionBlock(hidden_dim, channel * ratio, nhead=8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sa2(self.sa1(x))


class SelfAttentionBlockNoProj(SelfAttentionBlock):
    """:class:`SelfAttentionBlock` without the input projection (PointSea's):
    (B, N, d_out) -> (B, N, d_out)."""

    def __init__(self, d_out: int, nhead: int = 4, dim_feedforward: int = 1024):
        super().__init__(d_out, d_out, nhead, dim_feedforward)
        self.input_proj = nn.Identity()


class PointSeaSDGDecoder(nn.Module):
    """PointSea's SDG decoder: two no-projection self-attention blocks at the
    hidden width, 8 heads."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.sa1 = SelfAttentionBlockNoProj(hidden_dim, nhead=8)
        self.sa2 = SelfAttentionBlockNoProj(hidden_dim, nhead=8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sa2(self.sa1(x))


class EdgeConv(nn.Module):
    """DGCNN edge convolution: kNN in feature space (self included), edge
    features [central − neighbour ‖ central], two BN + LeakyReLU(0.2) layers
    and a linear one, max over neighbours. (B, N, C_in) -> (B, N, C_out)."""

    def __init__(self, in_channels: int, out_channels: int, k: int):
        super().__init__()
        self.k = k
        half = out_channels // 2
        self.conv0 = nn.Linear(2 * in_channels, half)
        self.bn0 = BatchNorm(half)
        self.conv1 = nn.Linear(half, half)
        self.bn1 = BatchNorm(half)
        self.conv2 = nn.Linear(half, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        neigh = group_local(x, k=self.k)  # (B, N, K, C)
        central = x[:, :, None, :].expand_as(neigh)
        feat = torch.cat([central - neigh, central], dim=-1)
        feat = F.leaky_relu(self.bn0(self.conv0(feat)), 0.2)
        feat = F.leaky_relu(self.bn1(self.conv1(feat)), 0.2)
        return self.conv2(feat).amax(dim=2)


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (K, K)."""
    x = np.arange(n, dtype=np.float64)[None, :]
    u = np.arange(n, dtype=np.float64)[:, None]
    mat = np.cos((np.pi / n) * (x + 0.5) * u) * np.sqrt(2.0 / n)
    mat[0, :] *= np.sqrt(0.5)
    return mat.astype(np.float32)


class PCSA(nn.Module):
    """Point cloud spectral adapter: DCT-II along the neighbourhood axis,
    per-patch frequency gates from channel-averaged features, inverse DCT.
    (B, S, K, C) -> same."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.register_buffer("dct", torch.from_numpy(dct_matrix(k)), persistent=False)
        hidden = max(8, k // 2)
        self.freq_fc1 = nn.Linear(k, hidden)
        self.freq_fc2 = nn.Linear(hidden, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = torch.sigmoid(self.freq_fc2(F.gelu(self.freq_fc1(x.mean(dim=-1)))))
        spec = torch.einsum("bskc,fk->bsfc", x, self.dct) * gates[..., None]
        return torch.einsum("bsfc,fk->bskc", spec, self.dct)


class SinusoidalPositionalEmbedding(nn.Module):
    """Interleaved [sin(w0 x), cos(w0 x), sin(w1 x), ...] embedding of scalar
    indices, detached from the graph."""

    def __init__(self, d_model: int):
        super().__init__()
        assert d_model % 2 == 0
        self.d_model = d_model
        div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
        self.register_buffer("div", torch.from_numpy(div.astype(np.float32)), persistent=False)

    def forward(self, emb_indices: torch.Tensor) -> torch.Tensor:
        omegas = emb_indices.detach()[..., None] * self.div
        emb = torch.stack([omegas.sin(), omegas.cos()], dim=-1)
        return emb.reshape(*emb_indices.shape, self.d_model)


class PointNetSAModuleKNN(nn.Module):
    """Set abstraction with FPS + kNN grouping: xyz (B, N, 3), points (B, N, C)
    -> new_xyz (B, npoint, 3), new_points (B, npoint, mlp[-1]) [, idx].
    Groups carry their relative coordinates ahead of the features. With
    ``use_pcsa`` (SVDFormer's) a kNN-grouped module runs PCSA on its groups
    before the max. The group-all module never does."""

    def __init__(self, npoint: Optional[int], nsample: Optional[int], in_channel: int,
                 mlp: Sequence[int], if_bn: bool = True, group_all: bool = False,
                 if_idx: bool = False, use_pcsa: bool = False):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.group_all, self.if_idx = group_all, if_idx
        self.mlp = SharedMLP(in_channel + 3, mlp, if_bn=if_bn, last_act=False)
        self.pcsa = PCSA(nsample) if use_pcsa and not group_all else None

    def forward(self, xyz, points):
        if self.group_all:
            new_xyz, new_points, idx, _ = sample_and_group_all(xyz, points)
        else:
            new_xyz, new_points, idx, _ = sample_and_group_knn(
                xyz, points, self.npoint, self.nsample)
        new_points = self.mlp(new_points)
        if self.pcsa is not None:
            new_points = self.pcsa(new_points)
        new_points = new_points.amax(dim=2)
        return (new_xyz, new_points, idx) if self.if_idx else (new_xyz, new_points)


def _group_width(in_channel: int, use_xyz: bool) -> int:
    """The width of a group's rows: the features, after the centred
    coordinates with ``use_xyz``; the coordinates alone without features."""
    return in_channel + 3 if use_xyz or in_channel == 0 else in_channel


class PointNetSAModule(nn.Module):
    """PointNet++ set abstraction with ball-query groups: xyz (B, N, 3),
    points (B, N, in_channel) or None -> new_xyz (B, npoint, 3), new_points
    (B, npoint, mlp[-1]); BatchNorm and ReLU after every layer. ``group_all``
    makes one group of every point."""

    def __init__(self, npoint: Optional[int], nsample: Optional[int], radius: Optional[float],
                 in_channel: int, mlp: Sequence[int], if_bn: bool = True,
                 group_all: bool = False, use_xyz: bool = True):
        super().__init__()
        self.npoint, self.nsample, self.radius = npoint, nsample, radius
        self.group_all, self.use_xyz = group_all, use_xyz
        self.mlp = SharedMLP(_group_width(in_channel, use_xyz), mlp, if_bn=if_bn, last_act=True)

    def forward(self, xyz, points):
        if self.group_all:
            new_xyz, new_points, _, _ = sample_and_group_all(xyz, points, self.use_xyz)
        else:
            new_xyz, new_points, _, _ = sample_and_group_ball(
                xyz, points, self.npoint, self.nsample, self.radius, self.use_xyz)
        return new_xyz, self.mlp(new_points).amax(dim=2)


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction: FPS picks ``npoint`` centres
    once; scale i ball-queries ``nsamples[i]`` points within ``radii[i]``,
    runs ``mlp{i}`` (BatchNorm and ReLU after every layer) and max-pools; the
    scales' features concatenate. ``npoint`` None: every scale sees the whole
    cloud, and new_xyz is None. Points None needs ``use_xyz``."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float], nsamples: Sequence[int],
                 in_channel: int, mlps: Sequence[Sequence[int]], if_bn: bool = True,
                 use_xyz: bool = True):
        super().__init__()
        assert len(radii) == len(nsamples) == len(mlps)
        self.npoint, self.radii, self.nsamples, self.use_xyz = npoint, radii, nsamples, use_xyz
        self.n = len(mlps)
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(_group_width(in_channel, use_xyz), mlp,
                                                 if_bn=if_bn, last_act=True))

    def forward(self, xyz, points):
        if self.npoint is None:
            new_xyz = None
            groups = [sample_and_group_all(xyz, points, self.use_xyz)[1]] * self.n
        else:
            assert points is not None or self.use_xyz, (
                "PointNetSAModuleMSG: points=None with use_xyz=False leaves the MLP no input")
            new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint))
            groups = []
            for radius, nsample in zip(self.radii, self.nsamples):
                idx = ball_query(radius, nsample, xyz, new_xyz)
                grouped = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
                if points is not None:
                    feats = grouping_operation(points, idx)
                    grouped = torch.cat([grouped, feats], dim=-1) if self.use_xyz else feats
                groups.append(grouped)
        return new_xyz, torch.cat([getattr(self, f"mlp{i}")(g).amax(dim=2)
                                   for i, g in enumerate(groups)], dim=-1)


class PointNetFeatureExtractor(nn.Module):
    """Vanilla PointNet: per-point linear ``conv{i}`` layers, each with an
    optional BatchNorm ``bn{i}``, ReLU on all but the last; the max over the
    points is the global feature (B, feat_size). Without ``global_feat`` it
    is broadcast back and concatenated, global first, with the first layer's
    activated features: (B, N, feat_size + layer_dims[0])."""

    def __init__(self, in_channels: int = 3, feat_size: int = 1024,
                 layer_dims: Sequence[int] = (64, 128), global_feat: bool = True,
                 batchnorm: bool = True):
        super().__init__()
        assert len(layer_dims) >= 1, "layer_dims must be non-empty"
        self.dims = (*layer_dims, feat_size)
        self.global_feat, self.batchnorm = global_feat, batchnorm
        for i, f in enumerate(self.dims):
            self.add_module(f"conv{i}", nn.Linear(in_channels, f))
            if batchnorm:
                self.add_module(f"bn{i}", BatchNorm(f))
            in_channels = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        local = None
        for i in range(len(self.dims)):
            x = getattr(self, f"conv{i}")(x)
            if self.batchnorm:
                x = getattr(self, f"bn{i}")(x)
            if i < len(self.dims) - 1:
                x = F.relu(x)
            if i == 0:
                local = x
        g = x.amax(dim=1)
        if self.global_feat:
            return g
        return torch.cat([g[:, None, :].expand(-1, x.shape[1], -1), local], dim=-1)


class PointNetFPModule(nn.Module):
    """PointNet++ feature propagation: the features ``points2`` (B, M, C2)
    of ``xyz2`` interpolated onto ``xyz1`` (B, N, 3) from the 3 nearest with
    inverse-distance weights (distances floored at 1e-10), concatenated with
    ``points1`` (B, N, C1) when ``use_points1``, through an MLP with
    BatchNorm and ReLU after every layer. ``in_channel`` = C2 (+ C1)."""

    def __init__(self, in_channel: int, mlp: Sequence[int], use_points1: bool = False,
                 if_bn: bool = True):
        super().__init__()
        self.use_points1 = use_points1
        self.mlp = SharedMLP(in_channel, mlp, if_bn=if_bn, last_act=True)

    def forward(self, xyz1, xyz2, points1, points2):
        dist, idx = three_nn(xyz1, xyz2)
        recip = 1.0 / dist.clamp_min(1e-10)
        weight = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
        interp = three_interpolate(points2, idx, weight)
        if self.use_points1:
            interp = torch.cat([interp, points1], dim=-1)
        return self.mlp(interp)
