"""HRNetV2-W32/48 for DeepLab — port of the JAX package's
``models/backbones/hrnetv2.py`` (reference ``network/backbone/hrnetv2.py``).

Stem (two stride-2 3×3 convs) → 4 bottlenecks at 1/4 → three multi-
resolution stages of basic-block branches joined by exchange units: a
branch receives every other, stride-2 3×3 conv chains down, 1×1 conv and
nearest ×2^k replication up. The 'V2' head resizes every branch to the
first (bilinear) and concatenates them: ``out`` has Σ w·2^i channels.
The wiring is the fixed one that the JAX package's converter targets (the
reference's own hrnet factories crash), with its names: ``conv1``/``bn1``/
``conv2``/``bn2``, ``layer1.{b}``, ``transition1.{0, 1.0}``,
``transition{2,3}``, ``stage{s}.{m}.branches.{i}.{b}`` and
``stage{s}.{m}.fuse_layers.{i}.{j}``. Returns ``{"low_level": the stage-1
output (256 ch, 1/4), "out": Σ w·2^i ch at 1/4}``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.interpolate import resize_bilinear
from ..blocks import Conv2d, batch_norm, conv_kxk
from .resnet import Bottleneck

# (modules, blocks a branch) of stages 2, 3, 4
STAGE_CFG = ((1, 4), (4, 4), (3, 4))


def _conv_bn(in_features: int, features: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [conv_kxk(in_features, features, 3, stride), batch_norm(features)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = conv_kxk(planes, planes, 3)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv_kxk(planes, planes, 3)
        self.bn2 = batch_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + x)


class HRModule(nn.Module):
    """Each branch's basic blocks, then the exchange: branch i receives
    Σ_j of branch j brought to its resolution and width, in j order, ReLU."""

    def __init__(self, widths: Sequence[int], n_blocks: int):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w) for _ in range(n_blocks))) for w in widths)
        fuse = []
        for i, wi in enumerate(widths):
            row = []
            for j, wj in enumerate(widths):
                if j > i:
                    row.append(nn.Sequential(Conv2d(wj, wi, 1, bias=False), batch_norm(wi)))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(wj, wi if k == i - j - 1 else wj, 2, relu=k < i - j - 1)
                        for k in range(i - j))))
                else:
                    row.append(nn.Identity())
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, (layer, x) in enumerate(zip(row, xs)):
                y = layer(x)
                if j > i:
                    s = 2 ** (j - i)
                    y = F.interpolate(y, scale_factor=s, mode="nearest")  # replication
                acc = y if acc is None else acc + y
            outs.append(torch.relu(acc))
        return outs


class HRNetV2(nn.Module):
    def __init__(self, width: int = 32):
        super().__init__()
        self.conv1 = conv_kxk(3, 64, 3, stride=2)
        self.bn1 = batch_norm(64)
        self.conv2 = conv_kxk(64, 64, 3, stride=2)
        self.bn2 = batch_norm(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64) for b in range(4)))
        w = [width * 2 ** i for i in range(4)]
        self.transition1 = nn.ModuleList([_conv_bn(256, w[0], 1, relu=True),
                                          nn.Sequential(_conv_bn(256, w[1], 2, relu=True))])
        self.transition2 = _conv_bn(w[1], w[2], 2, relu=True)
        self.transition3 = _conv_bn(w[2], w[3], 2, relu=True)
        for stage, (n_modules, n_blocks) in enumerate(STAGE_CFG, start=2):
            setattr(self, f"stage{stage}", nn.Sequential(
                *(HRModule(w[:stage], n_blocks) for _ in range(n_modules))))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        low = self.layer1(x)
        xs = [t(low) for t in self.transition1]
        for stage in (2, 3, 4):
            if stage > 2:
                xs.append(getattr(self, f"transition{stage - 1}")(xs[-1]))
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs)
        hw = xs[0].shape[-2:]
        ups = [resize_bilinear(v.permute(0, 2, 3, 1), hw).permute(0, 3, 1, 2) for v in xs[1:]]
        return {"low_level": low, "out": torch.cat([xs[0]] + ups, dim=1)}
