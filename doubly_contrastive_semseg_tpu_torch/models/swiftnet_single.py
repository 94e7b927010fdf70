"""Single-scale SwiftNets — port of the JAX package's
``models/swiftnet_single.py`` (reference ``network/backbone/resnet_18.py``):
``SingleScaleSwiftNet`` (``ResNet_swift``, ``resnet18_single``): one
ResNet-18 pass, SwiftNet's SPP at 1/32 and three skip-bottleneck
``Upsample`` steps to 128 channels at 1/4; ``HourglassSwiftNet``
(``ResNet_hourglass``, ``resnet18_hourglass``): the same plus a GANet-style
two-pass disparity hourglass; ``RGBDSwiftNet`` (``ResNet``,
``resnet18_rgbd``): RGB and depth trunks fused by channel attention after
every stage.

Module names are the reference's, which JAX's
``convert_reference_swiftnet_single`` (``torch_convert.py:641-716``) reads:
``conv1``/``bn1`` (the depth branch's ``conv1_d``/``bn1_d``),
``layer{1..4}[_d].{b}``, ``attention_{i}[_d].1``, ``spp.spp.{spp_bn,
spp0..2, spp_fuse}``, ``upsample.{0..2}.{bottleneck, blend_conv}``,
``conv4a`` and the ``Conv2x`` ladder. The decoder's skips and the SPP's
input are the post-ReLU stage outputs (the reference's in-place ReLU
aliases its "pre-ReLU" skips, JAX's module docstring).

Only ``SingleScaleSwiftNet`` normalises its input (its own ``SWIFT_MEAN``
and ``SWIFT_STD``, ``resnet_18.py:659-660``); the other two take raw pixels.
None takes gradient checkpointing or the fused stem (JAX passes those to
``resnet18``/``resnet34`` only, ``weathernet.py:89-97``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.input_pipeline import normalize, to_nhwc
from .blocks import (Conv2d, SpatialPyramidPooling, Upsample, batch_norm,
                     max_pool_3x3_s2)
from .resnet_pyramid import NUM_FEATURES, BasicBlock
from .stereo_extras import BasicConv, Conv2x

SWIFT_MEAN = (73.1584, 82.9090, 72.3924)
SWIFT_STD = (44.9149, 46.1529, 45.3192)
STAGE_PLANES = (64, 128, 256, 512)


def _trunk(module: nn.Module, suffix: str = "", in_channels: int = 3) -> None:
    """The stem ``conv1{suffix}``/``bn1{suffix}`` (7×7/2 → BN → ReLU →
    3×3/2 max-pool) and the four ResNet-18 stages ``layer{s}{suffix}``."""
    setattr(module, f"conv1{suffix}", Conv2d(in_channels, 64, 7, stride=2, padding=3,
                                             bias=False))
    setattr(module, f"bn1{suffix}", batch_norm(64))
    in_planes = 64
    for si, planes in enumerate(STAGE_PLANES):
        stride = 1 if si == 0 else 2
        setattr(module, f"layer{si + 1}{suffix}", nn.Sequential(
            BasicBlock(in_planes, planes, stride), BasicBlock(planes, planes)))
        in_planes = planes


def _stem(module: nn.Module, x: torch.Tensor, suffix: str = "") -> torch.Tensor:
    x = getattr(module, f"conv1{suffix}")(x)
    return max_pool_3x3_s2(torch.relu(getattr(module, f"bn1{suffix}")(x)))


def _swift_spp() -> SpatialPyramidPooling:
    """The trio's SPP (``resnet_18.py:706-715``): 3 levels of the (8, 4, 2,
    1) grids, bottleneck and output 128 wide, levels 128 // 3, BN momentum
    0.01 / 2."""
    return SpatialPyramidPooling(STAGE_PLANES[-1], num_levels=3, bt_size=NUM_FEATURES,
                                 level_size=NUM_FEATURES // 3, out_size=NUM_FEATURES,
                                 grids=(8, 4, 2, 1), bn_momentum=0.005)


def _decoder(module: nn.Module) -> None:
    module.spp = _swift_spp()
    module.upsample = nn.ModuleList(Upsample(w, NUM_FEATURES, NUM_FEATURES)
                                    for w in reversed(STAGE_PLANES[:-1]))


def _decode(module: nn.Module, x: torch.Tensor, skips) -> Tuple[torch.Tensor, torch.Tensor]:
    """SPP of ``x``, then the ``Upsample`` steps over the skips at 1/16, 1/8
    and 1/4: (features, the SPP output)."""
    spp = module.spp(x)
    y = spp
    for up, skip in zip(module.upsample, reversed(skips)):
        y = up(y, skip)
    return y, spp


class SingleScaleSwiftNet(nn.Module):
    """ResNet-18 → SPP at 1/32 → 3 ``Upsample`` steps → 128 channels at 1/4
    (reference ``ResNet_swift``, ``resnet_18.py:653-795``). ``forward(image)``
    takes pixels in any of the three layouts (``to_nhwc``) and returns
    (features as a channels_last NCHW tensor, {"skips_0": the SPP
    output})."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        _trunk(self)
        _decoder(self)

    def forward(self, image: torch.Tensor):
        x = normalize(image, SWIFT_MEAN, SWIFT_STD).to(self.dtype).permute(0, 3, 1, 2)
        x = _stem(self, x)
        skips = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            skips.append(x)
        y, spp = _decode(self, x, skips[:-1])
        return y, {"skips_0": spp}


class HourglassSwiftNet(nn.Module):
    """The single-scale SwiftNet plus the reference's disparity hourglass
    (``ResNet_hourglass``, ``resnet_18.py:449-651``; JAX ``:117-164``):
    ``conv4a`` takes layer 4 down to 1/64, the ``deconv*a`` steps climb to
    1/4, the ``conv*b`` steps descend again and the ``deconv*b`` steps give
    64-channel disparity features at 1/4. The reference's ``conv_final`` is
    never called and is left out, as in JAX. Raw pixels, no normalisation.

    Nothing reads the branch's output in the seg model: JAX's ``jit`` drops
    it in eval, while in training its BN running statistics still move. So
    the branch runs in training, and in eval only when ``forward`` is asked
    (``disparity=True``); its features are then ``additional["disp_feat"]``.
    The image's sides must be multiples of 64."""

    _LADDER = (("deconv4a", 1024, 512, True), ("deconv3a", 512, 256, True),
               ("deconv2a", 256, 128, True), ("deconv1a", 128, 64, True),
               ("conv1b", 64, 128, False), ("conv2b", 128, 256, False),
               ("conv3b", 256, 512, False), ("conv4b", 512, 1024, False),
               ("deconv4b", 1024, 512, True), ("deconv3b", 512, 256, True),
               ("deconv2b", 256, 128, True), ("deconv1b", 128, 64, True))

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        _trunk(self)
        _decoder(self)
        self.conv4a = BasicConv(512, 1024, stride=2)
        for name, cin, cout, deconv in self._LADDER:
            setattr(self, name, Conv2x(cin, cout, deconv=deconv))

    def disparity_features(self, skips) -> torch.Tensor:
        """The branch on the post-ReLU stage outputs (``forward_up_for_disp``,
        ``resnet_18.py:600-646``): 64 channels at 1/4."""
        l1, l2, l3, l4 = skips
        x = rem4 = self.conv4a(l4)
        rems_a = []
        for name, rem in zip(("deconv4a", "deconv3a", "deconv2a", "deconv1a"), (l4, l3, l2, l1)):
            x = getattr(self, name)(x, rem)
            rems_a.append(x)
        rems_b = []
        for name, rem in zip(("conv1b", "conv2b", "conv3b", "conv4b"),
                             (rems_a[2], rems_a[1], rems_a[0], rem4)):
            x = getattr(self, name)(x, rem)
            rems_b.append(x)
        for name, rem in zip(("deconv4b", "deconv3b", "deconv2b", "deconv1b"),
                             (rems_b[2], rems_b[1], rems_b[0], rems_a[3])):
            x = getattr(self, name)(x, rem)
        return x

    def forward(self, image: torch.Tensor, disparity: bool = False):
        x = to_nhwc(image).to(self.dtype).permute(0, 3, 1, 2)
        x = _stem(self, x)
        skips = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            skips.append(x)
        y, spp = _decode(self, x, skips[:-1])
        additional = {"skips_0": spp}
        if self.training or disparity:
            additional["disp_feat"] = self.disparity_features(skips)
        return y, additional


class RGBDSwiftNet(nn.Module):
    """Two-branch RGB + depth SwiftNet (reference ``ResNet``,
    ``resnet_18.py:206-447``, ``forward_down_fusion``): after every stage
    each branch is scaled by its own channel attention (global average pool
    → 1×1 conv with bias → sigmoid, ``attention_{i}[_d]``) and the two are
    summed into the RGB stream; the depth stream goes on from its attenuated
    features. The decoder's skips are the RGB stage outputs before the
    attention; the SPP takes the fused layer-4 sum. Raw pixels; ``depth``
    (B, H, W) or (B, H, W, 1), zeros when not given (JAX's ``WeatherNet``
    gates on a zero depth map then, ``weathernet.py:127-130``)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        _trunk(self)
        _trunk(self, "_d", in_channels=1)
        for si, planes in enumerate(STAGE_PLANES):
            for sfx in ("", "_d"):
                setattr(self, f"attention_{si + 1}{sfx}", nn.Sequential(
                    nn.AdaptiveAvgPool2d(1), Conv2d(planes, planes, 1, bias=True), nn.Sigmoid()))
        _decoder(self)

    def forward(self, image: torch.Tensor, depth: Optional[torch.Tensor] = None):
        image = to_nhwc(image)
        if depth is None:
            depth = torch.zeros(image.shape[:-1], device=image.device)
        d = torch.as_tensor(depth, device=image.device)
        if d.dim() == 4:
            d = d[..., 0]
        x = _stem(self, image.to(self.dtype).permute(0, 3, 1, 2))
        y = _stem(self, d.to(self.dtype)[:, None].contiguous(memory_format=torch.channels_last),
                  "_d")
        skips = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            y = getattr(self, f"layer{si + 1}_d")(y)
            skips.append(x)
            x = x * getattr(self, f"attention_{si + 1}")(x)
            y = y * getattr(self, f"attention_{si + 1}_d")(y)
            x = x + y
        out, spp = _decode(self, x, skips[:-1])
        return out, {"skips_0": spp}


BACKBONES: Dict[str, type] = {"resnet18_single": SingleScaleSwiftNet,
                              "resnet18_hourglass": HourglassSwiftNet,
                              "resnet18_rgbd": RGBDSwiftNet}
