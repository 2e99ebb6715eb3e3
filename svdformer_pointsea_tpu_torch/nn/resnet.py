"""The image trunks (NCHW inside, cuDNN convolutions).

- ``ImageTrunk``, SVDFormer's depth-image encoder: svdformer_pointsea_tpu/
  nn/resnet.py::ImageTrunk without its space-to-depth packing, a TPU layout
  transform with the same numerics: a stride-1 3x3 stem (1 -> feat_size) +
  BN + ReLU, ResNet layers (2, 2, 2, 2) at widths feat_size x (1, 2, 4, 8)
  with stride 1 then 2, 2, 2, and a global average pool.
- ``ResNet18``, PointSea's standard ResNet-18 trunk: a 7x7 stride-2 stem +
  BN + ReLU, a 3x3 stride-2 max-pool, layers at 64 / 128 / 256 / 512 with
  stride 1, 2, 2, 2, returning the (B, 512, H/32, W/32) feature map.

Parameter names follow the JAX tree (``stem_conv``, ``conv1``,
``layer2.block0.down_conv`` ...).

Under ``nn.precision.set_mixed_precision(True)`` both trunks run in bf16 as
the JAX package's do (its ``_trunk_dtype``): the input is cast to bf16,
every convolution runs on the bf16 activations with its weight cast to
bf16, every BatchNorm applies a bf16 affine (``nn/layers.py::BatchNorm``),
and the output (ImageTrunk's mean pool, ResNet18's feature map) is f32.
Parameters stay f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm
from svdformer_pointsea_tpu_torch.nn.precision import mixed_precision_enabled


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype: a bf16 input convolves with the
    weight cast to bf16 and gives a bf16 output."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


def _conv3x3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    """ResNet v1 basic block (NCHW)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm(planes, dim=1)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes, dim=1)
        if downsample:
            self.down_conv = Conv2d(in_planes, planes, 1, stride=stride, bias=False)
            self.down_bn = BatchNorm(planes, dim=1)
        else:
            self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(out + identity)


class _Layer(nn.Sequential):
    def __init__(self, in_planes: int, planes: int, blocks: int, stride: int):
        need_down = stride != 1 or in_planes != planes
        super().__init__()
        self.add_module("block0", BasicBlock(in_planes, planes, stride, downsample=need_down))
        for i in range(1, blocks):
            self.add_module(f"block{i}", BasicBlock(planes, planes))


class ImageTrunk(nn.Module):
    """(B, 1, H, W) depth images -> (B, feat_size * 8) features."""

    def __init__(self, feat_size: int = 16, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        fs = feat_size
        self.stem_conv = _conv3x3(1, fs)
        self.stem_bn = BatchNorm(fs, dim=1)
        self.layer1 = _Layer(fs, fs, layers[0], 1)
        self.layer2 = _Layer(fs, fs * 2, layers[1], 2)
        self.layer3 = _Layer(fs * 2, fs * 4, layers[2], 2)
        self.layer4 = _Layer(fs * 4, fs * 8, layers[3], 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if mixed_precision_enabled():
            x = x.to(torch.bfloat16)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.float().mean(dim=(2, 3))


class ResNet18(nn.Module):
    """(B, 3, H, W) images -> (B, 512, H/32, W/32) f32 feature maps."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, dim=1)
        self.layer1 = _Layer(64, 64, layers[0], 1)
        self.layer2 = _Layer(64, 128, layers[1], 2)
        self.layer3 = _Layer(128, 256, layers[2], 2)
        self.layer4 = _Layer(256, 512, layers[3], 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if mixed_precision_enabled():
            x = x.to(torch.bfloat16)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as flax's max_pool
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.float()
