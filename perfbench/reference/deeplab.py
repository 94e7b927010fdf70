"""DeepLabV3+ on a dilated ResNet-101 at output stride 16 (Chen et al.,
"Encoder-Decoder with Atrous Separable Convolution for Semantic Image
Segmentation", ECCV 2018, arXiv:1802.02611), as the DCSS model wraps it:
ASPP (1×1, 3×3 at rates 6/12/18, image pooling; 256 channels; dropout 0.1
after the projection), a 48-channel 1×1 projection of the stride-4
features, a 3×3 256 conv and a 1×1 classifier; the 2048-channel features
feed the weather classifier and the SupCon projection head. The pixels are
normalised as for SwiftNet. Names are the reference's torch
``state_dict`` names (``backbone.*``, ``classifier.*``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Projection, WeatherClassifier, bn, conv, normalize, resize, two_view_pool

RATES = (6, 12, 18)
DROPOUT = 0.1


class Bottleneck(nn.Module):
    def __init__(self, cin: int, c: int, stride: int, dilation: int):
        super().__init__()
        self.conv1 = conv(cin, c, 1)
        self.bn1 = bn(c)
        self.conv2 = conv(c, c, 3, stride, dilation)
        self.bn2 = bn(c)
        self.conv3 = conv(c, 4 * c, 1)
        self.bn3 = bn(4 * c)
        self.downsample = None
        if stride != 1 or cin != 4 * c:
            self.downsample = nn.Sequential(conv(cin, 4 * c, 1, stride), bn(4 * c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet101(nn.Module):
    """torchvision's ResNet-101 with the last stage's stride replaced by
    dilation 2 (output stride 16); its first block keeps dilation 1."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = bn(64)
        cin, dilation = 64, 1
        for s, (c, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 23, 3))):
            stride, first_dilation = (1 if s == 0 else 2), dilation
            if s == 3:
                dilation, stride = 2, 1
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(cin, c, stride if i == 0 else 1,
                                         first_dilation if i == 0 else dilation))
                cin = 4 * c
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        low = self.layer1(x)
        return low, self.layer4(self.layer3(self.layer2(low)))


def conv_bn_relu(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, k, dilation=dilation), bn(cout), nn.ReLU())


class ImagePool(nn.Sequential):
    def __init__(self, cin: int, c: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), conv(cin, c, 1), bn(c), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    def __init__(self, cin: int, c: int = 256):
        super().__init__()
        self.convs = nn.ModuleList([conv_bn_relu(cin, c, 1)]
                                   + [conv_bn_relu(cin, c, 3, r) for r in RATES]
                                   + [ImagePool(cin, c)])
        self.project = nn.Sequential(conv(5 * c, c, 1), bn(c), nn.ReLU())

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        y = self.project(torch.cat([m(x) for m in self.convs], dim=1))
        if not self.training:
            return y
        # the keep mask is drawn as (B, h, w, C) uniforms, kept where ≥ p
        b, c, h, w = y.shape
        keep = torch.rand((b, h, w, c), generator=generator, device=y.device) >= DROPOUT
        return torch.where(keep.permute(0, 3, 1, 2), y / (1.0 - DROPOUT), 0.0)


class HeadV3Plus(nn.Module):
    def __init__(self, cin: int, low: int, num_classes: int):
        super().__init__()
        self.project = conv_bn_relu(low, 48, 1)
        self.aspp = ASPP(cin)
        self.classifier = nn.Sequential(conv(304, 256, 3), bn(256), nn.ReLU(),
                                        conv(256, num_classes, 1, bias=True))

    def forward(self, low, out, generator):
        low = self.project(low)
        aspp = resize(self.aspp(out, generator), low.shape[-2:])
        return self.classifier(torch.cat([low, aspp], dim=1))


class DeepLabDCSS(nn.Module):
    """``forward(image, two_view, generator)``: the outputs of ``swiftnet.
    DCSS``; ``generator`` draws ASPP's dropout mask in training."""

    def __init__(self, num_classes: int = 19, weather_num: int = 4):
        super().__init__()
        self.backbone = ResNet101()
        self.classifier = HeadV3Plus(2048, 256, num_classes)
        self.weather_clf = WeatherClassifier(2048, weather_num)
        self.projection = Projection(2048, 128)

    def forward(self, image: torch.Tensor, two_view: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        low, feat = self.backbone(normalize(image).to(self.backbone.conv1.weight.dtype))
        b = feat.shape[0] // 2 if two_view else feat.shape[0]
        logits = self.classifier(low[:b], feat[:b], generator)
        feat0 = resize(feat[:b], logits.shape[-2:])
        out = {"seg_beforeup": logits, "seg": resize(logits, image.shape[1:3]),
               "fine_feat0": feat0, "weather_logits": self.weather_clf(feat0)}
        if two_view:
            out["supcon_proj"] = self.projection(two_view_pool(feat))
        return out


def build(num_classes: int = 19, weather_num: int = 4) -> DeepLabDCSS:
    return DeepLabDCSS(num_classes, weather_num)
