"""Neural building blocks, the SVDFormer, GeoSpecNet and PointSea models and
the discriminators (channels-last)."""

from svdformer_pointsea_tpu_torch.nn.discriminator import (
    PointDiscriminator,
    SimplePointDiscriminator,
)

from svdformer_pointsea_tpu_torch.nn.flash import FlashAttention, flash_attention_train
from svdformer_pointsea_tpu_torch.nn.geospecnet import (
    GeoSpecNet,
    MSGSpecConv,
    SpectralAdapter,
    SpectralFeatureExtractor,
    SVFNetGS,
)
from svdformer_pointsea_tpu_torch.nn.layers import (
    PCSA,
    BatchNorm,
    CrossAttentionBlock,
    EdgeConv,
    MLPConv,
    MultiheadAttention,
    PointNetSAModuleKNN,
    PointSeaSDGDecoder,
    SDGDecoder,
    SelfAttentionBlock,
    SelfAttentionBlockNoProj,
    SharedMLP,
    SinusoidalPositionalEmbedding,
    bn_row_weights,
    flash_attention,
    naive_attention,
    scaled_attention,
)
from svdformer_pointsea_tpu_torch.nn.pointsea import (
    PointSea,
    PointSeaLocalEncoder,
    PointSeaSDG,
    PointSeaSVFNet,
)
from svdformer_pointsea_tpu_torch.nn.precision import (
    mixed_precision,
    mixed_precision_enabled,
    set_mixed_precision,
)
from svdformer_pointsea_tpu_torch.nn.resnet import BasicBlock, ImageTrunk, ResNet18
from svdformer_pointsea_tpu_torch.nn.svdformer import SVDFormer, has_zero_gradient, init_parameters

__all__ = [
    "FlashAttention",
    "flash_attention_train",
    "PCSA",
    "BatchNorm",
    "CrossAttentionBlock",
    "EdgeConv",
    "MLPConv",
    "MultiheadAttention",
    "PointNetSAModuleKNN",
    "PointSeaSDGDecoder",
    "SDGDecoder",
    "SelfAttentionBlock",
    "SelfAttentionBlockNoProj",
    "SharedMLP",
    "SinusoidalPositionalEmbedding",
    "bn_row_weights",
    "flash_attention",
    "naive_attention",
    "scaled_attention",
    "mixed_precision",
    "mixed_precision_enabled",
    "set_mixed_precision",
    "BasicBlock",
    "ImageTrunk",
    "ResNet18",
    "SVDFormer",
    "GeoSpecNet",
    "MSGSpecConv",
    "SpectralAdapter",
    "SpectralFeatureExtractor",
    "SVFNetGS",
    "PointSea",
    "PointSeaLocalEncoder",
    "PointSeaSDG",
    "PointSeaSVFNet",
    "PointDiscriminator",
    "SimplePointDiscriminator",
    "has_zero_gradient",
    "init_parameters",
]
