"""SwiftNet pyramid ResNet-18/34 — port of the JAX package's
``models/resnet_pyramid.py`` (reference ``resnet_pyramid.py:55-417``).

A 3-level bicubic input pyramid feeds one shared ResNet trunk. The stem BN
is per level (``bn1_0/1/2``); every other parameter is shared. Each stage's
output passes a 1×1 bottleneck to 128 channels and is summed into a
resolution-indexed skip list, and 5 ``UpsampleBlend`` steps decode from the
coarsest skip sum up to 1/4 input resolution.

Module names follow the reference's torch ``state_dict`` (``conv1`` as a
dense 7×7 kernel, ``layer{s}.{b}.downsample.{0,1}``,
``upsample_bottlenecks{j}``, ``upsample_blends{i}``), so
``utils/convert.py`` and the JAX package's torch converter both apply.

Training with ``efficient=True`` checkpoints each BasicBlock's (conv1, bn1,
ReLU) and (conv2, bn2) as the reference does (``do_efficient_fwd``,
reference ``resnet_pyramid.py:39-44``): ``torch.utils.checkpoint`` with
``use_reentrant=True``, whose recompute in the backward runs bn1 and bn2 in
training mode again and so folds the same batch moments into their running
stats a second time. The JAX package reproduces that in closed form
(``update_passes=2``, JAX ``models/blocks.py:54-65``). The downsample branch
is not checkpointed and updates once. The training stem is the plain
conv → BN → ReLU → pool.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.input_pipeline import build_pyramid, build_pyramid_cols
from ..ops.stem import fused_stem_pool, fused_stem_pool_cols
from .blocks import Conv2d, UpsampleBlend, batch_norm, conv_cols, conv_kxk, max_pool_3x3_s2

NUM_FEATURES = 128   # decoder width
PYRAMID_LEVELS = 3


class BasicBlock(nn.Module):
    """conv3×3(s) → BN → ReLU → conv3×3 → BN, projection shortcut on a
    stride or width change, add, ReLU (reference ``resnet_pyramid.py:55-89``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 efficient: bool = False):
        super().__init__()
        self.efficient = efficient
        self.conv1 = conv_kxk(in_planes, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv_kxk(planes, planes, 3, 1)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                batch_norm(planes))

    def _part1(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn1(self.conv1(x)))

    def _part2(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.conv2(x))

    def _run(self, part, x: torch.Tensor) -> torch.Tensor:
        # reference do_efficient_fwd: checkpoint only where a gradient flows
        if self.efficient and self.training and x.requires_grad:
            return checkpoint(part, x, use_reentrant=True, preserve_rng_state=False)
        return part(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._run(self._part2, self._run(self._part1, x))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)

    def forward_cols(self, x: torch.Tensor, width: int):
        """The block in eval on a width-split map (``blocks.conv_cols``):
        (this rank's output columns, the output width)."""
        out, w_out = conv_cols(self.conv1, x, width)
        out, _ = conv_cols(self.conv2, torch.relu(self.bn1(out)), w_out)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv_cols(self.downsample[0], x, width)[0])
        return torch.relu(self.bn2(out) + residual), w_out


class PyramidResNet(nn.Module):
    """Shared-trunk pyramid ResNet. ``forward(image)`` takes (B, H, W, 3)
    pixels and returns (decoded 128-channel features at 1/4 resolution as a
    channels_last NCHW tensor, {"skips_0": the coarsest skip})."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 fuse_stem: bool = True, efficient: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fuse_stem = fuse_stem
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        for i in range(PYRAMID_LEVELS):
            setattr(self, f"bn1_{i}", batch_norm(64))
        in_planes = 64
        for si, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(self._block(in_planes, planes, stride, efficient))
                in_planes = planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            # each bottleneck after its stage: seeded weights draw in this order
            setattr(self, f"upsample_bottlenecks{si + 1}",
                    conv_kxk(planes, NUM_FEATURES, k=1))
        add_pyramid_decoder(self)

    def _block(self, in_planes: int, planes: int, stride: int, efficient: bool) -> nn.Module:
        return BasicBlock(in_planes, planes, stride, efficient)

    def _stage(self, j: int, x: torch.Tensor, idx: int) -> torch.Tensor:
        """Stage ``j`` of the trunk on pyramid level ``idx``'s stream."""
        return getattr(self, f"layer{j + 1}")(x)

    def _stem(self, level: torch.Tensor, idx: int) -> torch.Tensor:
        bn = getattr(self, f"bn1_{idx}")
        if self.fuse_stem and not self.training:
            scale, shift = bn.folded()
            x = fused_stem_pool(level, self.conv1.weight, scale, shift)
            return x.permute(0, 3, 1, 2)
        x = self.conv1(level.permute(0, 3, 1, 2))
        return max_pool_3x3_s2(torch.relu(bn(x)))

    def forward(self, image: torch.Tensor):
        pyramid = build_pyramid(image, PYRAMID_LEVELS, self.dtype)
        skips = pyramid_skips()
        for idx, level in enumerate(pyramid):
            x = self._stem(level, idx)
            for j in range(4):
                x = self._stage(j, x, idx)
                skips[idx + j].append(getattr(self, f"upsample_bottlenecks{j + 1}")(x))
        return pyramid_decode(self, skips)

    def check_split(self) -> None:
        """Raises for what the width-split forward does not run: training
        (JAX shows no width-split training) and ``fuse_inference`` on a
        blend (K5's fused step has no width-split route). It never falls
        back to another route."""
        if self.training:
            raise ValueError("PyramidResNet: the width-split forward runs in eval mode only "
                             "(JAX shows no width-split training)")
        for m in self.modules():
            if isinstance(m, UpsampleBlend) and m.fuse_inference:
                raise ValueError("PyramidResNet: fuse_inference (K5, ops/blend.py) has no "
                                 "width-split route (ROADMAP.md: K5 under the model axis)")

    def forward_split(self, image: torch.Tensor, width: int):
        """The eval forward on a width-split image (``parallel/spatial.py``):
        this rank's columns of an NHWC or planar image ``width`` wide →
        (this rank's columns of the decoded features, their width, {"skips_0":
        this rank's columns of the coarsest skip}). Every layer takes the
        halo it reads: the pyramid's bicubic taps, K2's window (three
        launches, one a level; the plain stem without ``fuse_stem``), the
        trunk's 3×3 and strided 1×1 convs, the blends' resize and 3×3. The
        1×1 bottlenecks, eval BN and the skip sums are local: equal global
        widths give equal ranges."""
        self.check_split()
        skips = pyramid_skips()
        for idx, (level, w) in enumerate(build_pyramid_cols(image, width, PYRAMID_LEVELS,
                                                            self.dtype)):
            scale, shift = getattr(self, f"bn1_{idx}").folded()
            x, w = fused_stem_pool_cols(level, w, self.conv1.weight, scale, shift,
                                        plain=not self.fuse_stem)
            x = x.permute(0, 3, 1, 2)
            for j in range(4):
                for block in getattr(self, f"layer{j + 1}"):
                    x, w = block.forward_cols(x, w)
                skips[idx + j].append(conv_cols(getattr(self, f"upsample_bottlenecks{j + 1}"),
                                                x, w))
        return pyramid_decode_cols(self, skips)


def add_pyramid_decoder(module: nn.Module, skip_widths: Sequence[int] = ()) -> None:
    """The pyramid harness's decoder on ``module``: a 1×1 bottleneck to 128
    channels for each of the 4 skip stages (``upsample_bottlenecks{1..4}``,
    their inputs ``skip_widths`` wide; none where the module registers its
    own) and ``PYRAMID_LEVELS`` + 2 blends (``upsample_blends{1..5}``:
    output stride 4)."""
    module.num_skip_levels = PYRAMID_LEVELS + 3
    for j, width in enumerate(skip_widths):
        setattr(module, f"upsample_bottlenecks{j + 1}", conv_kxk(width, NUM_FEATURES, k=1))
    for i in range(1, module.num_skip_levels):
        setattr(module, f"upsample_blends{i}", UpsampleBlend(NUM_FEATURES))


def pyramid_skips() -> Dict[int, list]:
    """The resolution-indexed skip lists: level ``idx``'s stage ``j`` lands
    in ``skips[idx + j]``."""
    return {lvl: [] for lvl in range(PYRAMID_LEVELS + 3)}


def pyramid_decode(module: nn.Module, skips: Dict[int, list]):
    """From the coarsest skip sum up the blend ladder of ``module``
    (``add_pyramid_decoder``): (decoded 128-channel features at 1/4
    resolution, {"skips_0": the coarsest skip})."""
    # reversed: the coarsest level first (reference resnet_pyramid.py:361)
    skips_r = [skips[lvl] for lvl in reversed(range(len(skips)))]
    x = skips_r[0][0]
    additional = {"skips_0": x}
    for i in range(1, len(skips)):
        skip_sum = skips_r[i][0]
        for s in skips_r[i][1:]:
            skip_sum = skip_sum + s
        x = getattr(module, f"upsample_blends{i}")(x, skip_sum)
    return x, additional


def pyramid_decode_cols(module: nn.Module, skips: Dict[int, list]):
    """``pyramid_decode`` on width-split maps: ``skips`` holds (this rank's
    columns, global width) pairs; (decoded features' columns, their width,
    {"skips_0": the coarsest skip's columns})."""
    skips_r = [skips[lvl] for lvl in reversed(range(len(skips)))]
    x, w = skips_r[0][0]
    additional = {"skips_0": x}
    for i in range(1, len(skips)):
        skip_sum, ws = skips_r[i][0]
        for s, _ in skips_r[i][1:]:
            skip_sum = skip_sum + s
        x, w = getattr(module, f"upsample_blends{i}").forward_cols(x, w, skip_sum, ws), ws
    return x, w, additional


def resnet18_pyramid(**kw) -> PyramidResNet:
    """SwiftNet-RN18 (reference ``resnet_pyramid.py:397-405``)."""
    return PyramidResNet(layers=(2, 2, 2, 2), **kw)


def resnet34_pyramid(**kw) -> PyramidResNet:
    return PyramidResNet(layers=(3, 4, 6, 3), **kw)
