"""Resizes with the semantics of the JAX package's ``ops/interpolate.py``.

The JAX side lowers each resize to blends and strided depthwise convolutions
for the TPU, bit-matched to torch's ``F.interpolate``; here ``F.interpolate``
is the definition itself. Public functions take NHWC tensors like their JAX
counterparts. Given a ``channels_last`` NCHW tensor's NHWC view, the permutes
below are views and no copy is made.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) → (B, size[0], size[1], C), bilinear with half-pixel
    centres (torch ``align_corners=False``)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def downsample_bicubic_direct(x: torch.Tensor, level: int) -> torch.Tensor:
    """Pyramid level ``level`` straight from the full-resolution NHWC image:
    ``F.interpolate(x, scale_factor=2**-level, mode="bicubic")`` (reference
    ``resnet_pyramid.py:306-314``; not an iterated /2 chain)."""
    if level == 0:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0 ** -level,
                      mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1)
