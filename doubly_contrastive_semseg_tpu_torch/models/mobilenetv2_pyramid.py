"""The pyramid MobileNetV2 — port of the JAX package's
``models/mobilenetv2_pyramid.py`` (reference
``network/backbone/mobilenetv2_pyramid.py:132-364``): the SwiftNet pyramid
harness (3-level bicubic pyramid, per-level stem BN, 1×1 bottlenecks to 128
channels summed by resolution, 5 ``UpsampleBlend`` steps) around a shared
MobileNetV2 inverted-residual trunk. Skip taps after the stages of 16
channels at 1/4, 24 at 1/8, 32 at 1/16 and 320 at 1/32; normalised with the
reference's MobileNetV2 constants (``:154-155``).

The stem is JAX's: a (4, 4, 12, 32) space-to-depth kernel over
``s2d_stem_geometry(7)`` with no mask, so all 192 slots a filter are live:
a dense 8×8 stride-2 kernel with padding (4, 3), not the reference's 7×7
(``ops/input_pipeline.py::s2d_kernel_to_dense``). The port holds it as that
dense ``conv1`` over the dense pyramid levels.

Block names are JAX's ``ir{stage}_{channels}_{index}``, each block the
DeepLab backbone's ``InvertedResidual`` (its reference-named ``conv``
Sequential, its input padded by its dilation).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.input_pipeline import build_pyramid, s2d_dense_padding
from .backbones.mobilenetv2 import InvertedResidual
from .blocks import Conv2d, batch_norm, max_pool_3x3_s2
from .resnet_pyramid import PYRAMID_LEVELS, add_pyramid_decoder, pyramid_decode, pyramid_skips

MNV2_MEAN = (73.1584, 82.9090, 72.3924)
MNV2_STD = (44.9149, 46.1529, 45.3192)

# (expand t, channels c, repeats n, stride s, dilation d) by skip stage: with
# the reference's output-stride-16 bookkeeping the 160-group is stride 1,
# dilation 2; with the stem's max-pool the stages end at 1/4 … 1/32
STAGES = (
    ((1, 16, 1, 1, 1),),
    ((6, 24, 2, 2, 1),),
    ((6, 32, 3, 2, 1),),
    ((6, 64, 4, 2, 1), (6, 96, 3, 1, 1), (6, 160, 3, 1, 2), (6, 320, 1, 1, 2)),
)


class PyramidMobileNetV2(nn.Module):
    """``forward(image)``: pixels in any of the three layouts → (128-channel
    features at 1/4 as a channels_last NCHW tensor, {"skips_0": the coarsest
    skip})."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.padding = s2d_dense_padding(7)
        self.conv1 = Conv2d(3, 32, 8, stride=2, bias=False)
        for i in range(PYRAMID_LEVELS):
            setattr(self, f"bn1_{i}", batch_norm(32))
        self.stages = []
        in_ch = 32
        for si, group in enumerate(STAGES):
            names = []
            for t, c, n, s, dil in group:
                for bi in range(n):
                    name = f"ir{si}_{c}_{bi}"
                    setattr(self, name, InvertedResidual(in_ch, c, s if bi == 0 else 1, dil, t))
                    names.append(name)
                    in_ch = c
            self.stages.append(names)
        add_pyramid_decoder(self, [group[-1][1] for group in STAGES])

    def forward(self, image: torch.Tensor):
        pyramid = build_pyramid(image, PYRAMID_LEVELS, self.dtype, MNV2_MEAN, MNV2_STD)
        skips = pyramid_skips()
        top, bottom = self.padding
        for idx, level in enumerate(pyramid):
            x = self.conv1(F.pad(level.permute(0, 3, 1, 2), (top, bottom, top, bottom)))
            x = max_pool_3x3_s2(torch.relu(getattr(self, f"bn1_{idx}")(x)))
            for j, names in enumerate(self.stages):
                for name in names:
                    x = getattr(self, name)(x)
                skips[idx + j].append(getattr(self, f"upsample_bottlenecks{j + 1}")(x))
        return pyramid_decode(self, skips)
