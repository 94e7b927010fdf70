"""SwiftNet-RN18 with the pyramid (Oršić & Šegvić, "Efficient semantic
segmentation with pyramidal fusion", Pattern Recognition 2021), as the DCSS
model wraps it: a 3-level bicubic input pyramid through one shared
ResNet-18 (a stem BN per level), a 1×1 bottleneck to 128 channels after
every stage, skips summed by resolution, five upsample-blend steps to 1/4
resolution, a BN → ReLU → 1×1 seg head with 19 classes, a 4-way weather
classifier and the SupCon projection head. Names are the reference's torch
``state_dict`` names."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Projection, WeatherClassifier, bn, conv, normalize, resize, two_view_pool

LEVELS = 3
FEATURES = 128


class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = conv(cin, c, 3, stride)
        self.bn1 = bn(c)
        self.conv2 = conv(c, c, 3)
        self.bn2 = bn(c)
        self.downsample = None
        if stride != 1 or cin != c:
            self.downsample = nn.Sequential(conv(cin, c, 1, stride), bn(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class PreAct(nn.Module):
    """BN → ReLU → conv."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = False):
        super().__init__()
        self.norm = bn(cin)
        self.conv = conv(cin, cout, k, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.norm(x)))


class Blend(nn.Module):
    def __init__(self):
        super().__init__()
        self.blend_conv = PreAct(FEATURES, FEATURES, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.blend_conv(resize(x, skip.shape[-2:]) + skip)


class PyramidResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        for i in range(LEVELS):
            setattr(self, f"bn1_{i}", bn(64))
        cin = 64
        for s, c in enumerate((64, 128, 256, 512)):
            setattr(self, f"layer{s + 1}", nn.Sequential(
                BasicBlock(cin, c, 1 if s == 0 else 2), BasicBlock(c, c, 1)))
            setattr(self, f"upsample_bottlenecks{s + 1}", conv(c, FEATURES, 1))
            cin = c
        for i in range(1, LEVELS + 3):
            setattr(self, f"upsample_blends{i}", Blend())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalised → (B, 128, H/4, W/4)."""
        skips = {i: [] for i in range(LEVELS + 3)}
        for idx in range(LEVELS):
            level = x if idx == 0 else F.interpolate(x, scale_factor=0.5 ** idx, mode="bicubic",
                                                     align_corners=False)
            y = torch.relu(getattr(self, f"bn1_{idx}")(self.conv1(level)))
            y = F.max_pool2d(y, 3, stride=2, padding=1)
            for j in range(4):
                y = getattr(self, f"layer{j + 1}")(y)
                skips[idx + j].append(getattr(self, f"upsample_bottlenecks{j + 1}")(y))
        order = [skips[i] for i in reversed(range(LEVELS + 3))]
        y = order[0][0]
        for i in range(1, LEVELS + 3):
            y = getattr(self, f"upsample_blends{i}")(y, sum(order[i][1:], order[i][0]))
        return y


class WeatherNet(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.feature_extractor = PyramidResNet18()
        self.segmentation = PreAct(FEATURES, num_classes, 1, bias=True)


class DCSS(nn.Module):
    """The paper's model: ``forward(image, two_view, generator)`` on (B, H,
    W, 3) pixels gives NCHW float32 maps: ``seg_beforeup`` (the head's
    logits at 1/4), ``seg`` (their bilinear resize to the image),
    ``fine_feat0`` (the first view's features), ``weather_logits``, and with
    ``two_view`` (the two views stacked, 2B images) ``supcon_proj`` (B, 2,
    128). The model draws nothing, so ``generator`` goes unused."""

    def __init__(self, num_classes: int = 19, weather_num: int = 4):
        super().__init__()
        self.net = WeatherNet(num_classes)
        self.weather_clf = WeatherClassifier(FEATURES, weather_num)
        self.projection = Projection(FEATURES, 128)

    def forward(self, image: torch.Tensor, two_view: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        x = normalize(image).to(self.net.segmentation.conv.weight.dtype)
        feat = self.net.feature_extractor(x)
        feat0 = feat[: feat.shape[0] // 2] if two_view else feat
        logits = self.net.segmentation(feat0)
        out = {"seg_beforeup": logits, "seg": resize(logits, image.shape[1:3]),
               "fine_feat0": feat0, "weather_logits": self.weather_clf(feat0)}
        if two_view:
            out["supcon_proj"] = self.projection(two_view_pool(feat))
        return out


def build(num_classes: int = 19, weather_num: int = 4) -> DCSS:
    return DCSS(num_classes, weather_num)
