"""Dilated ResNet-50/101 for the DeepLab family — port of the JAX package's
``models/backbones/resnet.py`` (reference ``network/backbone/resnet.py``,
torchvision's ResNet with ``replace_stride_with_dilation``).

A stage whose stride is replaced dilates its 3×3 convs by the accumulated
factor instead of downsampling: output stride 16 ([F, F, T]) or 8 ([F, T,
T]). As in torchvision's ``_make_layer`` and JAX, the first block of a
dilated stage keeps the previous dilation; the rest take the new one.
Module names are torchvision's (``conv1``, ``bn1``, ``layer{s}.{b}.conv1..3``,
``downsample.{0,1}``), the reference's ``backbone.*`` under
``IntermediateLayerGetter``. Returns ``{"low_level": layer1 (256 ch, 1/4),
"out": layer4 (2048 ch)}``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..blocks import Conv2d, batch_norm, conv_kxk, max_pool_3x3_s2


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride, dilation) → 1×1 ×4, projection shortcut on a
    stride or width change."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv_kxk(planes, planes, 3, stride, dilation=dilation)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = batch_norm(out)
        self.downsample = None
        if stride != 1 or in_planes != out:
            self.downsample = nn.Sequential(Conv2d(in_planes, out, 1, stride=stride, bias=False),
                                            batch_norm(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class DilatedResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 replace_stride_with_dilation: Sequence[bool] = (False, False, True)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        in_planes, dilation = 64, 1
        for si, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if si == 0 else 2
            prev_dilation = dilation
            if si > 0 and replace_stride_with_dilation[si - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(in_planes, planes, stride if bi == 0 else 1,
                                         prev_dilation if bi == 0 else dilation))
                in_planes = planes * Bottleneck.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))
        low = self.layer1(x)
        return {"low_level": low, "out": self.layer4(self.layer3(self.layer2(low)))}


def resnet50(replace_stride_with_dilation=(False, False, True)) -> DilatedResNet:
    return DilatedResNet((3, 4, 6, 3), replace_stride_with_dilation)


def resnet101(replace_stride_with_dilation=(False, False, True)) -> DilatedResNet:
    return DilatedResNet((3, 4, 23, 3), replace_stride_with_dilation)
