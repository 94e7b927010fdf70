"""DeepLabV3 / V3+ with the doubly-contrastive output contract — port of the
JAX package's ``models/deeplab.py`` (reference ``network/_deeplab.py:
28-185``, ``network/modeling.py:44-231``, ``network/utils.py:159-194``).

Outputs, in the JAX package's NHWC layout: ``seg`` logits at the input
size; ``seg_beforeup`` the head's (1/4 for V3+, 1/output_stride for V3);
``fine_feat`` the backbone's ``out`` for both views (2048 / 320 / 480 / 720
channels); ``fine_feat0`` the first view resized (bilinear) to
``seg_beforeup``'s size; ``weather_logits``; and ``supcon_proj`` with
``return_supcon_feature``. ASPP rates [6, 12, 18] at output stride 16,
[12, 24, 36] at 8, and [12, 24, 36] for HRNet at either (``modeling.py:
20``). ``separable`` turns the heads' 3×3 convs into depthwise-separable
ones. The pixels are normalised as for SwiftNet, JAX's default
(``normalize_input=True``, ``deeplab.py:141-146``), where the reference
feeds raw 0–255 pixels into the trunk; the port keeps JAX's choice.

Module names are the reference's torch ``state_dict`` names
(``backbone.*``; V3+: ``classifier.{project, aspp, classifier}``, V3:
``classifier.{0..4}``, where the JAX package's converter reads them), so the
JAX package's ``convert_reference_deeplab`` reads the port's weights as they
are; ``weather_clf`` and ``projection`` as in ``DCSSModel``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..ops.input_pipeline import image_hw, normalize
from ..ops.interpolate import resize_bilinear
from ..utils.profiling import span
from .backbones.hrnetv2 import HRNetV2
from .backbones.mobilenetv2 import MobileNetV2
from .backbones.resnet import resnet50, resnet101
from .backbones.xception import AlignedXception
from .blocks import Conv2d, Dropout, SeparableConv, batch_norm, conv_kxk
from .weathernet import ProjectionHead, WeatherClassifier, nhwc, two_view_pool

# backbone → (its ``out`` channels, its ``low_level`` channels)
BACKBONE_CHANNELS = {"resnet50": (2048, 256), "resnet101": (2048, 256),
                     "mobilenetv2": (320, 24), "xception": (2048, 128),
                     "hrnetv2_32": (480, 256), "hrnetv2_48": (720, 256)}


def conv_bn_relu(in_features: int, features: int, k: int = 3, dilation: int = 1,
                 separable: bool = False) -> nn.Sequential:
    """conv (padding dilation·(k//2), separable for k > 1 if asked) → BN →
    ReLU, as the reference's Sequentials (``0`` conv, ``1`` BN)."""
    if separable and k > 1:
        conv = SeparableConv(in_features, features, k, dilation=dilation)
    else:
        conv = conv_kxk(in_features, features, k, dilation=dilation)
    return nn.Sequential(conv, batch_norm(features), nn.ReLU())


class ASPPPooling(nn.Sequential):
    """Global average pool → 1×1 conv → BN → ReLU, broadcast back over the
    map (``convs.4``: ``1`` conv, ``2`` BN)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), Conv2d(in_features, features, 1, bias=False),
                         batch_norm(features), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """1×1 ‖ three dilated 3×3 ‖ image pooling → concat → 1×1 project →
    dropout 0.1 (reference ``_deeplab.py:140-168``)."""

    def __init__(self, in_features: int, rates: Sequence[int], features: int = 256,
                 separable: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(in_features, features, 1)]
            + [conv_bn_relu(in_features, features, 3, r, separable) for r in rates]
            + [ASPPPooling(in_features, features)])
        self.project = nn.Sequential(Conv2d(5 * features, features, 1, bias=False),
                                     batch_norm(features), nn.ReLU(), Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([conv(x) for conv in self.convs], dim=1))


class DeepLabHeadV3Plus(nn.Module):
    """low-level 1×1 → 48 ‖ ASPP resized to it → 3×3 256 → 1×1 classes
    (reference ``_deeplab.py:28-66``)."""

    def __init__(self, in_features: int, low_features: int, num_classes: int,
                 rates: Sequence[int], separable: bool = False):
        super().__init__()
        self.project = conv_bn_relu(low_features, 48, 1)
        self.aspp = ASPP(in_features, rates, separable=separable)
        self.classifier = nn.Sequential(*conv_bn_relu(304, 256, 3, separable=separable),
                                        Conv2d(256, num_classes, 1, bias=True))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        low = self.project(features["low_level"])
        aspp = nhwc(self.aspp(features["out"]))
        aspp = resize_bilinear(aspp, tuple(low.shape[-2:])).permute(0, 3, 1, 2)
        return self.classifier(torch.cat([low, aspp], dim=1))


class DeepLabHead(nn.Sequential):
    """ASPP → 3×3 256 → 1×1 classes (reference ``_deeplab.py:68-90``), as the
    JAX package's converter names it: ``0`` ASPP, ``1`` conv, ``2`` BN,
    ``4`` the classifier."""

    def __init__(self, in_features: int, num_classes: int, rates: Sequence[int],
                 separable: bool = False):
        super().__init__(ASPP(in_features, rates, separable=separable),
                         *conv_bn_relu(256, 256, 3, separable=separable),
                         Conv2d(256, num_classes, 1, bias=True))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        return super().forward(features["out"])


def build_backbone(name: str, output_stride: int) -> nn.Module:
    rsd = (False, True, True) if output_stride == 8 else (False, False, True)
    if name == "resnet50":
        return resnet50(rsd)
    if name == "resnet101":
        return resnet101(rsd)
    if name == "mobilenetv2":
        return MobileNetV2(output_stride)
    if name == "xception":
        return AlignedXception(output_stride)
    if name.startswith("hrnetv2_"):
        return HRNetV2(int(name.rsplit("_", 1)[-1]))
    raise NotImplementedError(f"backbone {name}")


class DeepLabDCSS(nn.Module):
    """DeepLabV3/V3+ + the weather classifier + (with ``projection``) the
    SupCon projection head. ``image`` is pixels in NHWC (or planar or s2d,
    ``ops/input_pipeline.py::to_nhwc``); parameters are float32 and
    activations run in ``dtype``."""

    def __init__(self, arch: str = "deeplabv3plus", backbone: str = "resnet50",
                 num_classes: int = 19, weather_num: int = 4, output_stride: int = 16,
                 separable: bool = False, projection: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        rates = (12, 24, 36) if output_stride == 8 or backbone.startswith("hrnetv2") \
            else (6, 12, 18)
        out_ch, low_ch = BACKBONE_CHANNELS[backbone]
        self.backbone = build_backbone(backbone, output_stride)
        if arch == "deeplabv3plus":
            self.classifier = DeepLabHeadV3Plus(out_ch, low_ch, num_classes, rates, separable)
        else:
            self.classifier = DeepLabHead(out_ch, num_classes, rates, separable)
        self.weather_clf = WeatherClassifier(out_ch, weather_num)
        self.projection = ProjectionHead(out_ch, 128) if projection else None

    def forward(self, image: torch.Tensor,
                return_supcon_feature: bool = False) -> Dict[str, torch.Tensor]:
        size = image_hw(image)
        with span("dcss.input"):
            x = normalize(image).to(self.dtype).permute(0, 3, 1, 2)
        with span("dcss.trunk"):
            features = self.backbone(x)
        del x   # the input is not held through the heads
        fine_feat = features["out"]
        if return_supcon_feature:
            bsz = fine_feat.shape[0] // 2
            features = {k: v[:bsz] for k, v in features.items()}
        with span("dcss.decoder"):
            seg_beforeup = nhwc(self.classifier(features)).float()
        with span("dcss.head"):
            out = {
                "seg": resize_bilinear(seg_beforeup, size),
                "seg_beforeup": seg_beforeup,
                "fine_feat": nhwc(fine_feat),
                "fine_feat0": resize_bilinear(nhwc(features["out"]),
                                              tuple(seg_beforeup.shape[1:3])),
            }
            out["weather_logits"] = self.weather_clf(out["fine_feat0"])
            if return_supcon_feature:
                out["supcon_proj"] = self.projection(two_view_pool(out["fine_feat"]))
        return out


def parse_deeplab_name(name: str):
    """``deeplabv3[plus]_<backbone>`` → (arch, backbone), ``mobilenet`` read
    as ``mobilenetv2`` (reference ``network/modeling.py:132-231``)."""
    for arch in ("deeplabv3plus", "deeplabv3"):
        if name.startswith(arch + "_"):
            backbone = name[len(arch) + 1:]
            return arch, "mobilenetv2" if backbone == "mobilenet" else backbone
    raise NotImplementedError(f"deeplab model {name}")


def build_deeplab_dcss(cfg, dtype: torch.dtype) -> DeepLabDCSS:
    arch, backbone = parse_deeplab_name(cfg.model)
    return DeepLabDCSS(arch=arch, backbone=backbone, num_classes=cfg.num_classes,
                       weather_num=cfg.weather_num, output_stride=cfg.output_stride,
                       separable=cfg.separable_conv, projection=cfg.use_supcon, dtype=dtype)
