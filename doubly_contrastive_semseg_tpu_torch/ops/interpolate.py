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


# torch's channels_last bilinear kernel takes fewer output elements than this
_INT_MAX = 2 ** 31 - 1


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) → (B, size[0], size[1], C), bilinear with half-pixel
    centres (torch ``align_corners=False``). An output of 2³¹ elements or
    more (DeepLab's 2048-channel ``fine_feat0`` of a 2048×1024 batch of 8)
    is resized a few samples at a time."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    per_sample = size[0] * size[1] * x.shape[3]
    step = max(1, _INT_MAX // max(per_sample, 1))
    if x.shape[0] > step:
        return torch.cat([resize_bilinear(x[i:i + step], size)
                          for i in range(0, x.shape[0], step)])
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize with torch's asymmetric map ``src = floor(dst·in/out)``
    (JAX ``ops/interpolate.py::resize_nearest``), as an index gather, so
    integer label maps stay exact. A 4-d tensor is NHWC; otherwise the last
    two dims are (H, W)."""
    h_ax, w_ax = (1, 2) if x.dim() == 4 else (x.dim() - 2, x.dim() - 1)
    in_h, in_w = x.shape[h_ax], x.shape[w_ax]
    out_h, out_w = size
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device)
                       * (in_h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device)
                       * (in_w / out_w)).long()
    return x.index_select(h_ax, rows).index_select(w_ax, cols)


def downsample_bicubic_direct(x: torch.Tensor, level: int) -> torch.Tensor:
    """Pyramid level ``level`` straight from the full-resolution NHWC image:
    ``F.interpolate(x, scale_factor=2**-level, mode="bicubic")`` (reference
    ``resnet_pyramid.py:306-314``; not an iterated /2 chain)."""
    if level == 0:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0 ** -level,
                      mode="bicubic", align_corners=False)
    return y.permute(0, 2, 3, 1)
