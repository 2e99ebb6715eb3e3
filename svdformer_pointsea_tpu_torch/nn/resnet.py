"""SVDFormer's depth-image trunk (NCHW inside, cuDNN convolutions).

Mirrors svdformer_pointsea_tpu/nn/resnet.py::ImageTrunk without its
space-to-depth packing, a TPU layout transform with the same numerics: a
stride-1 3x3 stem (1 -> feat_size) + BN + ReLU, ResNet layers (2, 2, 2, 2) at
widths feat_size x (1, 2, 4, 8) with stride 1 then 2, 2, 2, and a global
average pool. Parameter names follow the JAX tree (``stem_conv``,
``layer2.block0.down_conv`` ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    """ResNet v1 basic block (NCHW)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm(planes, dim=1)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes, dim=1)
        if downsample:
            self.down_conv = nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False)
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
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))
