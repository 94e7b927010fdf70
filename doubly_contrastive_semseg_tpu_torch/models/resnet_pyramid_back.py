"""The "back" revision of the pyramid ResNet — port of the JAX package's
``models/resnet_pyramid_back.py`` (reference
``network/backbone/resnet_pyramid_back.py``): the flagship pyramid with a
BatchNorm per pyramid level in every block, so trunk statistics do not mix
across scales.

The stem is the flagship's (a dense 7×7 ``conv1``, the masked s2d kernel
JAX stores), always the plain conv → BN → ReLU → pool: JAX fuses the stem
(K2) and checkpoints the blocks for ``resnet18``/``resnet34`` only
(``weathernet.py:89-97``). A block's convs keep the flagship's names;
its per-level BNs take JAX's (``bn1_{l}``, ``bn2_{l}``,
``downsample_bn_{l}``), which neither converter maps from the reference's
``bn1.{l}`` ModuleLists.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Conv2d, batch_norm, conv_kxk
from .resnet_pyramid import PYRAMID_LEVELS, PyramidResNet


class BasicBlockPerLevelBN(nn.Module):
    """The flagship's ``BasicBlock`` with a BN per pyramid level
    (``forward(x, level)``, reference ``resnet_pyramid_back.py:55-89``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 levels: int = PYRAMID_LEVELS):
        super().__init__()
        self.conv1 = conv_kxk(in_planes, planes, 3, stride)
        self.conv2 = conv_kxk(planes, planes, 3, 1)
        for lvl in range(levels):
            setattr(self, f"bn1_{lvl}", batch_norm(planes))
            setattr(self, f"bn2_{lvl}", batch_norm(planes))
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(Conv2d(in_planes, planes, 1, stride=stride,
                                                   bias=False))
            for lvl in range(levels):
                setattr(self, f"downsample_bn_{lvl}", batch_norm(planes))

    def forward(self, x: torch.Tensor, level: int) -> torch.Tensor:
        out = torch.relu(getattr(self, f"bn1_{level}")(self.conv1(x)))
        out = getattr(self, f"bn2_{level}")(self.conv2(out))
        residual = x
        if self.downsample is not None:
            residual = getattr(self, f"downsample_bn_{level}")(self.downsample(x))
        return torch.relu(out + residual)


class PyramidResNetBack(PyramidResNet):
    """``PyramidResNet`` with ``BasicBlockPerLevelBN`` blocks, each run with
    its pyramid level's BNs, and the plain stem."""

    def __init__(self, layers=(2, 2, 2, 2), dtype: torch.dtype = torch.float32):
        super().__init__(layers, fuse_stem=False, efficient=False, dtype=dtype)

    def _block(self, in_planes: int, planes: int, stride: int, efficient: bool) -> nn.Module:
        return BasicBlockPerLevelBN(in_planes, planes, stride)

    def _stage(self, j: int, x: torch.Tensor, idx: int) -> torch.Tensor:
        for block in getattr(self, f"layer{j + 1}"):
            x = block(x, idx)
        return x


def resnet18_pyramid_back(dtype: torch.dtype = torch.float32) -> PyramidResNetBack:
    return PyramidResNetBack((2, 2, 2, 2), dtype=dtype)
