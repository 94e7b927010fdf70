"""The EfficientNet-B0 pyramid — port of the JAX package's
``models/efficientnet_pyramid.py`` (reference
``network/backbone/efficientnet_pyramid.py:35-531`` and its vendored
``efficientnet_pytorch``): the SwiftNet pyramid harness around a shared
MBConv trunk (swish, squeeze-excite, drop-connect, TF-SAME depthwise
padding), skip taps after the stages of 24 channels at 1/4, 40 at 1/8, 112
at 1/16 and 320 at 1/32. JAX's backbone returns the standard two-tuple where
the reference's crashes ``WeatherNet``; the port follows JAX.

The stem is JAX's, not the reference's 3×3 TF-SAME conv: a (2, 2, 12, 32)
space-to-depth ``nn.Conv`` over ``s2d_stem_geometry(3)`` with no mask, a
dense 4×4 stride-2 kernel with padding (2, 1)
(``ops/input_pipeline.py::s2d_kernel_to_dense``), held as the dense
``stem_conv`` over the dense pyramid levels. BNs have momentum 0.01 and eps
1e-3 (``efficientnet_pytorch/utils.py``). Module names are JAX's:
``stem_conv``, ``stem_bn_{l}``, ``stage{s}_{b}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.input_pipeline import build_pyramid, s2d_dense_padding
from .blocks import Conv2d, DropConnect, batch_norm
from .resnet_pyramid import PYRAMID_LEVELS, add_pyramid_decoder, pyramid_decode, pyramid_skips

# (expand ratio, channels, repeats, stride, kernel): EfficientNet-B0
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# stage → skip index: the stride-4/8/16/32 stage outputs
SKIP_STAGES = {1: 0, 2: 1, 4: 2, 6: 3}
DROP_CONNECT = 0.2


def _bn(features: int) -> nn.BatchNorm2d:
    return batch_norm(features, momentum=0.01, eps=1e-3)


class MBConv(nn.Module):
    """Mobile inverted bottleneck (JAX ``efficientnet_pyramid.py:51-114``):
    [1×1 expand → BN → swish] → depthwise k×k at ``stride`` with TF-SAME
    padding (symmetric at stride 1, heavier at the bottom and right at
    stride 2) → BN → swish → squeeze-excite (mean → 1×1 → swish → 1×1 →
    sigmoid, both convs with bias) → 1×1 project → BN, and on a residual
    block drop-connect at rate ``drop_connect`` in training, then the add."""

    def __init__(self, in_features: int, features: int, expand_ratio: int, kernel: int = 3,
                 stride: int = 1, se_ratio: float = 0.25, drop_connect: float = DROP_CONNECT):
        super().__init__()
        hidden = in_features * expand_ratio
        self.kernel, self.stride = kernel, stride
        self.use_res = stride == 1 and in_features == features
        if expand_ratio != 1:
            self.expand_conv = Conv2d(in_features, hidden, 1, bias=False)
            self.bn0 = _bn(hidden)
        else:
            self.expand_conv = None
        self.depthwise_conv = Conv2d(hidden, hidden, kernel, stride=stride, groups=hidden,
                                     bias=False)
        self.bn1 = _bn(hidden)
        se = max(1, int(in_features * se_ratio))
        self.se_reduce = Conv2d(hidden, se, 1, bias=True)
        self.se_expand = Conv2d(se, hidden, 1, bias=True)
        self.project_conv = Conv2d(hidden, features, 1, bias=False)
        self.bn2 = _bn(features)
        self.drop = DropConnect(drop_connect) if self.use_res and drop_connect > 0 else None

    def _tf_same(self, size: int):
        total = max((-(-size // self.stride) - 1) * self.stride + self.kernel - size, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.expand_conv is not None:
            out = F.silu(self.bn0(self.expand_conv(out)))
        (top, bottom), (left, right) = self._tf_same(out.shape[2]), self._tf_same(out.shape[3])
        out = self.depthwise_conv(F.pad(out, (left, right, top, bottom)))
        out = F.silu(self.bn1(out))
        se = self.se_expand(F.silu(self.se_reduce(out.mean(dim=(2, 3), keepdim=True))))
        out = self.bn2(self.project_conv(out * torch.sigmoid(se)))
        if self.use_res:
            if self.drop is not None:
                out = self.drop(out)
            out = out + x
        return out


class PyramidEfficientNet(nn.Module):
    """``forward(image)``: pixels in any of the three layouts → (128-channel
    features at 1/4 as a channels_last NCHW tensor, {"skips_0": the coarsest
    skip}). Drop-connect grows with the global block index, ``0.2 · i /
    16`` (reference ``efficientnet_pytorch/model.py:262-264``), drawn by
    ``blocks.DropConnect`` from the generator ``set_dropout_generator``
    gives; each block draws anew on each pyramid level."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.padding = s2d_dense_padding(3)
        self.stem_conv = Conv2d(3, 32, 4, stride=2, bias=False)
        for i in range(PYRAMID_LEVELS):
            setattr(self, f"stem_bn_{i}", _bn(32))
        total = sum(n for (_, _, n, _, _) in B0_BLOCKS)
        self.stages, gidx, in_ch = [], 0, 32
        for si, (t, c, n, s, k) in enumerate(B0_BLOCKS):
            names = []
            for bi in range(n):
                setattr(self, f"stage{si}_{bi}", MBConv(
                    in_ch, c, t, kernel=k, stride=s if bi == 0 else 1,
                    drop_connect=DROP_CONNECT * gidx / total))
                names.append(f"stage{si}_{bi}")
                in_ch, gidx = c, gidx + 1
            self.stages.append(names)
        add_pyramid_decoder(self, [B0_BLOCKS[si][1] for si in SKIP_STAGES])

    def forward(self, image: torch.Tensor):
        pyramid = build_pyramid(image, PYRAMID_LEVELS, self.dtype)
        skips = pyramid_skips()
        top, bottom = self.padding
        for idx, level in enumerate(pyramid):
            x = self.stem_conv(F.pad(level.permute(0, 3, 1, 2), (top, bottom, top, bottom)))
            x = F.silu(getattr(self, f"stem_bn_{idx}")(x))
            for si, names in enumerate(self.stages):
                for name in names:
                    x = getattr(self, name)(x)
                if si in SKIP_STAGES:
                    j = SKIP_STAGES[si]
                    skips[idx + j].append(getattr(self, f"upsample_bottlenecks{j + 1}")(x))
        return pyramid_decode(self, skips)
