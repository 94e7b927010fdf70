"""The legacy stereo feature extractors — port of the JAX package's
``models/stereo_features.py`` (reference ``network/feature.py:36-1163``):
``StereoNetFeature``, ``PSMNetFeature``, ``GCNetFeature``, ``GANetFeature``,
the AANet ``FeaturePyramid``, ``FeaturePyramidNetwork``,
``MobileNetV2Feature`` (one module, ``decoder`` "none" or "hourglass") and
the factory ``make_stereo_feature``. No entry point builds them; they are
part of the capability surface, as in JAX.

Images and feature maps are NHWC at the public edge, as in JAX; inside they
are NCHW in ``channels_last`` memory. Parameters are float32 and cast to
the activations' dtype (``dtype``) at the call. ``GANetFeature`` takes
sides that are multiples of 48 (its /3 stem, then four halvings).

Module names are JAX's module paths in torch form (``down0.conv``,
``res3.downsample_bn``, ``layer2_0``, ``conv_start1_bn``, ``ir4_2``, ...),
so ``utils/convert.py::from_jax_variables`` carries a JAX module's
variables across; the pieces the port shares with other models keep their
own names: ``stereo_extras.BasicConv`` (``conv``, ``bn``) and ``Conv2x``
(``conv1``, ``conv2``), ``backbones/mobilenetv2.py::conv_bn_relu6``
(``0``, ``1``) and ``InvertedResidual`` (``conv.{...}``), and
``ops/deform_conv.py::DeformConv2d`` (``offset_conv``, ``deform_conv``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import DeformConv2d
from ..ops.interpolate import resize_bilinear
from .backbones.mobilenetv2 import InvertedResidual, conv_bn_relu6
from .blocks import Conv2d, batch_norm
from .stereo_extras import BasicConv, Conv2x


def nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC map as the NCHW (``channels_last``) view the modules take."""
    return x.to(dtype).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    """k×k ``conv`` (padding dilation·(k//2), no bias) → ``bn`` → ReLU
    unless ``relu`` is off (JAX ``_ConvBNReLU``)."""

    def __init__(self, in_features: int, features: int, k: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = Conv2d(in_features, features, k, stride=stride,
                           padding=dilation * (k // 2), dilation=dilation, bias=False)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class ResBlock(nn.Module):
    """Two 3×3 ``ConvBNReLU`` (the second without ReLU) plus the input, or
    its 1×1 ``downsample`` → ``downsample_bn`` projection where the stride
    or the width changes, then ReLU (JAX ``_ResBlock``)."""

    def __init__(self, in_features: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = ConvBNReLU(in_features, planes, 3, stride, dilation)
        self.conv2 = ConvBNReLU(planes, planes, 3, 1, dilation, relu=False)
        self.project = stride != 1 or in_features != planes
        if self.project:
            self.downsample = Conv2d(in_features, planes, 1, stride=stride, bias=False)
            self.downsample_bn = batch_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.downsample_bn(self.downsample(x)) if self.project else x
        return torch.relu(self.conv2(self.conv1(x)) + r)


class StereoNetFeature(nn.Module):
    """``num_downsample`` 5×5/s2 ``ConvBNReLU`` (``down{i}``), six
    ``ResBlock`` (``res{i}``), a bare biased 3×3 (``final``). (B, H, W, 3)
    → (B, H/2^N, W/2^N, ``channels``)."""

    def __init__(self, num_downsample: int = 3, channels: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_downsample, self.dtype = num_downsample, dtype
        for i in range(num_downsample):
            setattr(self, f"down{i}", ConvBNReLU(3 if i == 0 else channels, channels, 5, 2))
        for i in range(6):
            setattr(self, f"res{i}", ResBlock(channels, channels))
        self.final = Conv2d(channels, channels, 3, padding=1, bias=True)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = nchw(img, self.dtype)
        for i in range(self.num_downsample):
            x = getattr(self, f"down{i}")(x)
        for i in range(6):
            x = getattr(self, f"res{i}")(x)
        return nhwc(self.final(x))


# PSMNet's residual layers: (name, blocks, width, first stride, dilation)
_PSMNET_LAYERS = (("layer1", 3, 32, 1, 1), ("layer2", 16, 64, 2, 1),
                  ("layer3", 3, 128, 1, 1), ("layer4", 3, 128, 1, 2))
_SPP_POOLS = (64, 32, 16, 8)


class PSMNetFeature(nn.Module):
    """PSMNet's feature net: a 3-conv /2 stem (``firstconv{0,1,2}``), the
    residual layers ``layerL_i`` (a 16-block ``layer2`` at /4, a dilated
    ``layer4``), four SPP branches (average pools of 64/32/16/8, each window
    capped at the map's size, ``branch{j}`` 1×1 → 32, bilinear back), and
    the fuse ``lastconv0`` 320 → 128, ``lastconv1`` 1×1 → 32. (B, H, W, 3)
    → (B, H/4, W/4, 32)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.firstconv0 = ConvBNReLU(3, 32, 3, 2)
        self.firstconv1 = ConvBNReLU(32, 32)
        self.firstconv2 = ConvBNReLU(32, 32)
        cin = 32
        for name, n, c, s, d in _PSMNET_LAYERS:
            for i in range(n):
                setattr(self, f"{name}_{i}", ResBlock(cin, c, s if i == 0 else 1, d))
                cin = c
        for j in range(len(_SPP_POOLS)):
            setattr(self, f"branch{j}", ConvBNReLU(128, 32, 1))
        self.lastconv0 = ConvBNReLU(64 + 128 + 32 * len(_SPP_POOLS), 128)
        self.lastconv1 = Conv2d(128, 32, 1, bias=False)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = nchw(img, self.dtype)
        x = self.firstconv2(self.firstconv1(self.firstconv0(x)))
        for name, n, *_ in _PSMNET_LAYERS:
            for i in range(n):
                x = getattr(self, f"{name}_{i}")(x)
            if name == "layer2":
                out_raw = x
        h, w = x.shape[-2:]
        branches = []
        for j, pool in enumerate(_SPP_POOLS):
            window = (min(pool, h), min(pool, w))
            b = getattr(self, f"branch{j}")(F.avg_pool2d(x, window, stride=window))
            branches.append(resize_bilinear(nhwc(b), (h, w)).permute(0, 3, 1, 2).to(x.dtype))
        cat = torch.cat([out_raw, x, *branches[::-1]], dim=1)
        return nhwc(self.lastconv1(self.lastconv0(cat)))


class GCNetFeature(nn.Module):
    """5×5/s2 ``conv1``, eight ``ResBlock`` (``res{i}``), a biased 3×3
    ``conv3``. (B, H, W, 3) → (B, H/2, W/2, 32)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBNReLU(3, 32, 5, 2)
        for i in range(8):
            setattr(self, f"res{i}", ResBlock(32, 32))
        self.conv3 = Conv2d(32, 32, 3, padding=1, bias=True)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.conv1(nchw(img, self.dtype))
        for i in range(8):
            x = getattr(self, f"res{i}")(x)
        return nhwc(self.conv3(x))


# GANet's U-net widths, level 0 (the /3 stem) to 4
_GANET_WIDTHS = (32, 48, 64, 96, 128)


class GANetFeature(nn.Module):
    """GANet's two-pass U-net feature extractor: ``conv_start0`` 3×3, the
    5×5/s3 ``conv_start1`` (padding 2) → ``conv_start1_bn`` → ReLU, then
    ``conv_start2``; four stride-2 encoders ``conv{1..4}a``; the decoder
    ``deconv{4..1}a``, the second encoder ``conv{1..4}b`` and decoder
    ``deconv{4..1}b`` (``Conv2x`` steps fed the skips). With
    ``feature_mdconv`` ``conv_start2``, ``conv3a`` and ``conv4a`` are
    ``DeformConv2d`` (bare, no BN), and ``conv3b``, ``conv4b`` are
    ``Conv2x(mdconv=True)``, whose flag is ignored (plain convs, as in the
    reference). Returns JAX's six NHWC maps ``[rem2a, rem4a, rem0da, rem2b,
    rem4b, out]``, ``out`` 32 channels at /3."""

    def __init__(self, feature_mdconv: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = _GANET_WIDTHS
        self.conv_start0 = BasicConv(3, 32)
        self.conv_start1 = Conv2d(32, 32, 5, stride=3, padding=2, bias=False)
        self.conv_start1_bn = batch_norm(32)
        for i in range(1, 5):
            deform = feature_mdconv and i >= 3
            setattr(self, f"conv{i}a",
                    DeformConv2d(c[i - 1], c[i], stride=2) if deform
                    else BasicConv(c[i - 1], c[i], stride=2))
        self.conv_start2 = (DeformConv2d(32, 32) if feature_mdconv
                            else BasicConv(32, 32))
        for p in "ab":
            for i in range(4, 0, -1):
                setattr(self, f"deconv{i}{p}", Conv2x(c[i], c[i - 1], deconv=True))
        for i in range(1, 5):
            setattr(self, f"conv{i}b", Conv2x(c[i - 1], c[i], mdconv=feature_mdconv and i >= 3))

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv_start0(nchw(img, self.dtype))
        x = self.conv_start2(torch.relu(self.conv_start1_bn(self.conv_start1(x))))
        rem_a = [x]
        for i in range(1, 5):
            x = getattr(self, f"conv{i}a")(x)
            rem_a.append(x)
        rem_da = [None] * 4
        for i in range(4, 0, -1):
            x = getattr(self, f"deconv{i}a")(x, rem_a[i - 1])
            rem_da[i - 1] = x
        rem_b = [None] * 5
        for i in range(1, 5):
            x = getattr(self, f"conv{i}b")(x, rem_da[i] if i < 4 else rem_a[4])
            rem_b[i] = x
        for i in range(4, 0, -1):
            x = getattr(self, f"deconv{i}b")(x, rem_b[i - 1] if i > 1 else rem_da[0])
        return [nhwc(t) for t in (rem_a[2], rem_a[4], rem_da[0], rem_b[2], rem_b[4], x)]


class FeaturePyramid(nn.Module):
    """AANet's feature pyramid (reference ``FeaturePyrmaid``): twice a 3×3/s2
    conv → BN → LeakyReLU(0.2) → 1×1 conv → BN → LeakyReLU(0.2)
    (``out{i}_conv{0,1}``, ``out{i}_bn{0,1}``), widening 2× and 4×.
    (B, H, W, C) → [x, (B, H/2, W/2, 2C), (B, H/4, W/4, 4C)]."""

    def __init__(self, in_features: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = in_features
        for i, mult in enumerate((2, 4)):
            c = in_features * mult
            setattr(self, f"out{i}_conv0", Conv2d(cin, c, 3, stride=2, padding=1, bias=False))
            setattr(self, f"out{i}_bn0", batch_norm(c))
            setattr(self, f"out{i}_conv1", Conv2d(c, c, 1, bias=False))
            setattr(self, f"out{i}_bn1", batch_norm(c))
            cin = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, y = [x], nchw(x, self.dtype)
        for i in range(2):
            y = F.leaky_relu(getattr(self, f"out{i}_bn0")(getattr(self, f"out{i}_conv0")(y)), 0.2)
            y = F.leaky_relu(getattr(self, f"out{i}_bn1")(getattr(self, f"out{i}_conv1")(y)), 0.2)
            outs.append(nhwc(y))
        return outs


class FeaturePyramidNetwork(nn.Module):
    """The standard FPN over the first ``num_levels`` maps of widths
    ``in_features``: biased 1×1 laterals (``lateral{i}``), each coarser one
    added bilinearly into the next finer, then a 3×3 conv → BN → ReLU
    (``fpn{i}``, ``fpn{i}_bn``). NHWC lists in and out."""

    def __init__(self, in_features: Sequence[int] = (32, 64, 128), out_channels: int = 128,
                 num_levels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_levels, self.dtype = num_levels, dtype
        for i in range(num_levels):
            setattr(self, f"lateral{i}", Conv2d(in_features[i], out_channels, 1, bias=True))
            setattr(self, f"fpn{i}", Conv2d(out_channels, out_channels, 3, padding=1, bias=False))
            setattr(self, f"fpn{i}_bn", batch_norm(out_channels))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        lat = [nhwc(getattr(self, f"lateral{i}")(nchw(f, self.dtype)))
               for i, f in enumerate(feats[:self.num_levels])]
        for i in range(self.num_levels - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_bilinear(lat[i], tuple(lat[i - 1].shape[1:3])).to(
                self.dtype)
        return [nhwc(torch.relu(getattr(self, f"fpn{i}_bn")(
            getattr(self, f"fpn{i}")(x.permute(0, 3, 1, 2))))) for i, x in enumerate(lat)]


# (t, c, n, s): torchvision's schedule without the last /32 stride; groups 5
# and 6 dilated by 2
MOBILENET_SCHEDULE = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                      (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1))
MOBILENET_TAPS = (0, 1, 2, 4, 6)


class MobileNetV2Feature(nn.Module):
    """The MobileNetV2 stereo trunk (the reference's ``MobileNetV2``,
    ``MobileNetV2_New`` and ``MobileHourglass``, one architecture): a
    padded 3×3 ``conv_in`` at input resolution → ``stem`` 3×3/s2 (both
    ``conv_bn_relu6`` with padding 1) → the inverted residuals ``ir{g}_{b}``
    of ``MOBILENET_SCHEDULE``. Returns the NHWC list [16 @ 1, 16 @ /2, 24 @
    /4, 32 @ /8, 96 @ /16, 320 @ /16]; ``decoder="hourglass"`` appends the
    ``Conv2x`` deconvs ``up1`` (with the /8 map) and ``up2`` (with the /4
    one): 24 @ /4."""

    def __init__(self, decoder: str = "none", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.decoder, self.dtype = decoder, dtype
        self.conv_in = conv_bn_relu6(3, 16, padding=1)
        self.stem = conv_bn_relu6(16, 32, stride=2, padding=1)
        cin = 32
        for g, (t, c, n, s) in enumerate(MOBILENET_SCHEDULE):
            for b in range(n):
                setattr(self, f"ir{g}_{b}", InvertedResidual(cin, c, s if b == 0 else 1,
                                                             2 if g >= 5 else 1, t))
                cin = c
        if decoder == "hourglass":
            self.up1 = Conv2x(320, 32, deconv=True)
            self.up2 = Conv2x(32, 24, deconv=True)

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        x0 = self.conv_in(nchw(img, self.dtype))
        x = self.stem(x0)
        feats = [x0]
        for g, (_, _, n, _) in enumerate(MOBILENET_SCHEDULE):
            for b in range(n):
                x = getattr(self, f"ir{g}_{b}")(x)
            if g in MOBILENET_TAPS:
                feats.append(x)
        if self.decoder == "hourglass":
            feats.append(self.up2(self.up1(feats[-1], feats[3]), feats[2]))
        return [nhwc(f) for f in feats]


STEREO_FEATURES = {"stereonet": StereoNetFeature, "psmnet": PSMNetFeature,
                   "gcnet": GCNetFeature, "ganet": GANetFeature,
                   "mobilenetv2": MobileNetV2Feature}


def make_stereo_feature(kind: str, dtype: torch.dtype = torch.float32, **kw) -> nn.Module:
    """The legacy stereo feature extractor ``kind`` (a key of
    ``STEREO_FEATURES``); ``NotImplementedError`` for another."""
    if kind not in STEREO_FEATURES:
        raise NotImplementedError(f"stereo feature {kind}")
    return STEREO_FEATURES[kind](dtype=dtype, **kw)
