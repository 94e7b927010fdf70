"""MobileNetV2 with output-stride control for DeepLab — port of the JAX
package's ``models/backbones/mobilenetv2.py`` (reference
``network/backbone/mobilenetv2.py``, the VainF fork of torchvision's).

The inverted-residual schedule (t, c, n, s) of torchvision; once the
accumulated stride reaches ``output_stride``, a stride-2 block becomes
dilated instead, the first such block keeping the previous rate. The
fork's quirk, kept for checkpoint parity: every conv has padding 0 (the
stem too, so its border pixels drop), and each block pads its INPUT by its
depthwise dilation and runs expand → depthwise → project on the padded map;
since the expand's BN shifts the zero border, the depthwise conv sees a
non-zero border. Module names are the reference's after the factory's split
(``network/modeling.py:85-96``): ``low_level_features.{0..3}`` (stem and
blocks 1–3) and ``high_level_features.{4..17}``, each block's
``conv.{...}`` Sequential as torchvision's. Returns ``{"low_level": 24 ch
at 1/4, "out": 320 ch}``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks import Conv2d, batch_norm

INVERTED_RESIDUAL_SETTING = [
    # t, c, n, s
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class ReLU6(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, 0.0, 6.0)


def conv_bn_relu6(in_features: int, features: int, k: int = 3, stride: int = 1,
                  dilation: int = 1, groups: int = 1, padding: int = 0) -> nn.Sequential:
    """conv (padding 0 unless given) → BN → ReLU6, the fork's ``ConvBNReLU``
    (the stereo trunk's stem passes a padding, JAX ``ConvBNReLU6.pad``)."""
    return nn.Sequential(Conv2d(in_features, features, k, stride=stride, padding=padding,
                                dilation=dilation, groups=groups, bias=False),
                         batch_norm(features), ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int, dilation: int,
                 expand_ratio: int):
        super().__init__()
        hidden = in_features * expand_ratio
        self.use_res = stride == 1 and in_features == features
        self.pad = dilation
        layers = [conv_bn_relu6(in_features, hidden, k=1)] if expand_ratio != 1 else []
        layers += [conv_bn_relu6(hidden, hidden, stride=stride, dilation=dilation, groups=hidden),
                   Conv2d(hidden, features, 1, bias=False), batch_norm(features)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(F.pad(x, (self.pad,) * 4))
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        blocks = [conv_bn_relu6(3, 32, stride=2)]
        in_features, current_stride, dilation = 32, 2, 1
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for i in range(n):
                stride = s if i == 0 else 1
                d = dilation
                if stride == 2 and current_stride >= output_stride:
                    dilation *= stride
                    d, stride = dilation // stride, 1
                blocks.append(InvertedResidual(in_features, c, stride, d, t))
                if stride == 2:
                    current_stride *= 2
                in_features = c
        self.low_level_features = nn.Sequential(
            OrderedDict((str(i), blocks[i]) for i in range(4)))
        self.high_level_features = nn.Sequential(
            OrderedDict((str(i), blocks[i]) for i in range(4, len(blocks))))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        low = self.low_level_features(x)
        return {"low_level": low, "out": self.high_level_features(low)}
