"""Neural building blocks and the SVDFormer model (channels-last)."""

from svdformer_pointsea_tpu_torch.nn.layers import (
    PCSA,
    BatchNorm,
    CrossAttentionBlock,
    EdgeConv,
    MLPConv,
    MultiheadAttention,
    PointNetSAModuleKNN,
    SDGDecoder,
    SelfAttentionBlock,
    SharedMLP,
    SinusoidalPositionalEmbedding,
    flash_attention,
    naive_attention,
    scaled_attention,
)
from svdformer_pointsea_tpu_torch.nn.resnet import BasicBlock, ImageTrunk
from svdformer_pointsea_tpu_torch.nn.svdformer import SVDFormer, init_parameters

__all__ = [
    "PCSA",
    "BatchNorm",
    "CrossAttentionBlock",
    "EdgeConv",
    "MLPConv",
    "MultiheadAttention",
    "PointNetSAModuleKNN",
    "SDGDecoder",
    "SelfAttentionBlock",
    "SharedMLP",
    "SinusoidalPositionalEmbedding",
    "flash_attention",
    "naive_attention",
    "scaled_attention",
    "BasicBlock",
    "ImageTrunk",
    "SVDFormer",
    "init_parameters",
]
