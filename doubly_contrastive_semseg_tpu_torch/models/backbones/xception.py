"""AlignedXception for DeepLab — port of the JAX package's
``models/backbones/xception.py`` (reference ``network/backbone/
xception.py``, from jfzhang95/pytorch-deeplab-xception).

Entry flow (two convs, blocks 1–3), 16 middle blocks, exit block 20 and
three separable convs; past the output stride, strides become dilations.
Block 20's last separable conv keeps dilation 1 (the reference appends its
``is_last`` conv with the default dilation; seen at output stride 8 only),
as in JAX. Module names are the reference's: a separable conv is
``conv1`` (depthwise) → ``bn`` → ``pointwise``, followed in a block's
``rep`` Sequential by its BN, with the ReLUs at their indices (``rep.{k}``,
so the JAX package's converter finds each by scanning); ``skip`` and
``skipbn``; exit ``conv{3,4,5}`` with ``bn{3,4,5}``. Returns
``{"low_level": ReLU of block 1 (128 ch, 1/4), "out": 2048 ch}``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..blocks import Conv2d, batch_norm, conv_kxk


class XSeparableConv(nn.Module):
    """Depthwise 3×3 (padding = dilation) → BN → pointwise 1×1."""

    def __init__(self, in_features: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_features, in_features, 3, stride=stride, padding=dilation,
                            dilation=dilation, groups=in_features, bias=False)
        self.bn = batch_norm(in_features)
        self.pointwise = Conv2d(in_features, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.bn(self.conv1(x)))


class XBlock(nn.Module):
    """[ReLU →] sep conv → BN for each of ``features`` (the first ReLU only
    with ``start_with_relu``; the stride on the last), plus a 1×1 conv + BN
    skip (``skip="conv"``), the input (``"sum"``) or nothing."""

    def __init__(self, in_features: int, features: Sequence[int], stride: int = 1,
                 dilation: int = 1, skip: str = "conv", start_with_relu: bool = True,
                 last_dilation: int = None):
        super().__init__()
        rep = []
        c = in_features
        for i, f in enumerate(features):
            if i > 0 or start_with_relu:
                rep.append(nn.ReLU())
            last = i == len(features) - 1
            d = last_dilation if last and last_dilation is not None else dilation
            rep += [XSeparableConv(c, f, stride if last else 1, d), batch_norm(f)]
            c = f
        self.rep = nn.Sequential(*rep)
        self.skip_kind = skip
        if skip == "conv":
            self.skip = Conv2d(in_features, features[-1], 1, stride=stride, bias=False)
            self.skipbn = batch_norm(features[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.rep(x)
        if self.skip_kind == "conv":
            return out + self.skipbn(self.skip(x))
        return out + x if self.skip_kind == "sum" else out


class AlignedXception(nn.Module):
    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride == 16:
            entry3_stride, mid_dil, exit_dil = 2, 1, (1, 2)
        else:
            entry3_stride, mid_dil, exit_dil = 1, 2, (2, 4)
        self.conv1 = conv_kxk(3, 32, 3, stride=2)
        self.bn1 = batch_norm(32)
        self.conv2 = conv_kxk(32, 64, 3)
        self.bn2 = batch_norm(64)
        self.block1 = XBlock(64, (128, 128, 128), stride=2, start_with_relu=False)
        self.block2 = XBlock(128, (256, 256, 256), stride=2, start_with_relu=False)
        self.block3 = XBlock(256, (728, 728, 728), stride=entry3_stride)
        for i in range(16):
            setattr(self, f"block{4 + i}", XBlock(728, (728, 728, 728), dilation=mid_dil,
                                                  skip="sum"))
        self.block20 = XBlock(728, (728, 1024, 1024), dilation=exit_dil[0], last_dilation=1)
        for n, (cin, cout) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
            setattr(self, f"conv{n}", XSeparableConv(cin, cout, dilation=exit_dil[1]))
            setattr(self, f"bn{n}", batch_norm(cout))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        # the reference's ReLU after block 1, stored as low_level
        low = torch.relu(self.block1(x))
        x = self.block2(low)
        for n in range(3, 21):
            x = getattr(self, f"block{n}")(x)
        for n in (3, 4, 5):
            x = torch.relu(getattr(self, f"bn{n}")(getattr(self, f"conv{n}")(x)))
        return {"low_level": low, "out": x}
