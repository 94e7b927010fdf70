"""The legacy RODSNet-era segmentation heads — port of the JAX package's
``models/legacy_segmentation.py`` (reference ``network/segmentation.py:
9-457``): ``DeConv2D``, ``SegmentationBranches``, ``SegmentationDeeplabV3``,
``SimpleSegmentation`` (depth 1–3) and ``DisparityFeature``. No entry point
builds them, as in JAX.

The heads read the NHWC feature list of ``stereo_features.
MobileNetV2Feature`` ([16 @ 1, 16 @ /2, 24 @ /4, 32 @ /8, 96 @ /16, 320 @
/16]) and return NHWC; inside, maps are NCHW in ``channels_last`` memory and
float32 parameters are cast to ``dtype`` at the call. Module names are
JAX's module paths in torch form (``deconv3.deconv``, ``deconv3.bn0``,
``pre_bn``, ``unet.conv_start1_bn``, ...), apart from the ASPP, which is
``deeplab.ASPP`` under the reference's names (``aspp.convs.{0..4}``,
``aspp.project``), so ``utils/convert.py::from_jax_variables`` carries a
JAX head's variables across.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.interpolate import resize_bilinear
from .blocks import Conv2d, ConvTranspose2d, batch_norm
from .deeplab import ASPP
from .stereo_extras import BasicConv
from .stereo_features import GANetFeature, nchw, nhwc

ASPP_RATES = (12, 24, 36)
ASPP_FEATURES = 256


class DeConv2D(nn.Module):
    """×2 transposed 4×4 ``deconv`` (JAX's SAME one: torch's ``padding=1``,
    2n rows) → ``bn0`` → ReLU → concat(skip) → 3×3 ``fuse`` → ``bn1`` →
    ReLU, NCHW in and out."""

    def __init__(self, in_features: int, features: int, skip_features: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_features, features, 4, stride=2, padding=1, bias=False)
        self.bn0 = batch_norm(features)
        self.fuse = Conv2d(features + skip_features, features, 3, padding=1, bias=False)
        self.bn1 = batch_norm(features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn0(self.deconv(x)))
        return torch.relu(self.bn1(self.fuse(torch.cat([x, skip.to(x.dtype)], dim=1))))


def _aspp_decoder(module: nn.Module, features: Sequence[torch.Tensor], steps) -> torch.Tensor:
    """``aspp`` over the deepest map, then the ``DeConv2D`` of ``steps``,
    each fed its skip: (B, C, h, w) NCHW."""
    skips = [nchw(f, module.dtype) for f in features]
    x = module.aspp(skips[5])
    for name, skip in steps:
        x = getattr(module, name)(x, skips[skip])
    return x


class SegmentationBranches(nn.Module):
    """ASPP on the 320-channel map, ``deconv3`` (with the /8 map),
    ``deconv2`` (/4) and ``deconv1`` (/2), a biased 1×1 ``classifier``:
    (B, H/2, W/2, classes) float32."""

    STEPS = (("deconv3", 3), ("deconv2", 2), ("deconv1", 1))

    def __init__(self, num_classes: int = 19, aspp_dilate: Sequence[int] = ASPP_RATES,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.aspp = ASPP(320, tuple(aspp_dilate))
        self.deconv3 = DeConv2D(ASPP_FEATURES, 32, 32)
        self.deconv2 = DeConv2D(32, 24, 24)
        self.deconv1 = DeConv2D(24, 16, 16)
        self.classifier = Conv2d(16, num_classes, 1, bias=True)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        return nhwc(self.classifier(_aspp_decoder(self, features, self.STEPS))).float()


class SegmentationDeeplabV3(nn.Module):
    """ASPP and a biased 1×1 ``classifier`` over one map, resized
    bilinearly to ``out_hw``: (B, *out_hw, classes) float32."""

    def __init__(self, num_classes: int = 19, aspp_dilate: Sequence[int] = ASPP_RATES,
                 in_features: int = 320, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.aspp = ASPP(in_features, tuple(aspp_dilate))
        self.classifier = Conv2d(ASPP_FEATURES, num_classes, 1, bias=True)

    def forward(self, feat: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        x = self.classifier(self.aspp(nchw(feat, self.dtype)))
        return resize_bilinear(nhwc(x).float(), tuple(out_hw))


class SimpleSegmentation(nn.Module):
    """The ``SimpleSegmentation1/2/3`` family: ``depth`` − 1 ``BasicConv``
    of ``width`` (``conv{i}``), a 3×3 ``pre`` conv to the classes →
    ``pre_bn`` → ReLU, a biased 1×1 ``classifier``: (B, h, w, classes)
    float32 at the features' resolution."""

    def __init__(self, num_classes: int = 19, depth: int = 1, width: int = 32,
                 in_features: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        cin = in_features
        for i in range(depth - 1):
            setattr(self, f"conv{i}", BasicConv(cin, width))
            cin = width
        self.pre = Conv2d(cin, num_classes, 3, padding=1, bias=False)
        self.pre_bn = batch_norm(num_classes)
        self.classifier = Conv2d(num_classes, num_classes, 1, bias=True)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = nchw(feat, self.dtype)
        for i in range(self.depth - 1):
            x = getattr(self, f"conv{i}")(x)
        return nhwc(self.classifier(torch.relu(self.pre_bn(self.pre(x))))).float()


class DisparityFeature(nn.Module):
    """The ASPP decoder driven to full resolution (``deconv3`` ... ``deconv0``,
    the last to 3 channels with the input-resolution map), re-encoded by
    ``unet``, a ``GANetFeature(feature_mdconv=True)``: its last map, (B,
    H/3, W/3, 32). The input sides must be multiples of 48."""

    STEPS = (("deconv3", 3), ("deconv2", 2), ("deconv1", 1), ("deconv0", 0))

    def __init__(self, aspp_dilate: Sequence[int] = ASPP_RATES,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.aspp = ASPP(320, tuple(aspp_dilate))
        self.deconv3 = DeConv2D(ASPP_FEATURES, 32, 32)
        self.deconv2 = DeConv2D(32, 24, 24)
        self.deconv1 = DeConv2D(24, 16, 16)
        self.deconv0 = DeConv2D(16, 3, 16)
        self.unet = GANetFeature(feature_mdconv=True, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.unet(nhwc(_aspp_decoder(self, features, self.STEPS)))[-1]
