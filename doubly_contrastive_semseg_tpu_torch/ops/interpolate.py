"""Resizes with the semantics of the JAX package's ``ops/interpolate.py``.

The JAX side lowers each resize to blends and strided depthwise convolutions
for the TPU, bit-matched to torch's ``F.interpolate``; here ``F.interpolate``
is the definition itself. Public functions take NHWC tensors like their JAX
counterparts. Given a ``channels_last`` NCHW tensor's NHWC view, the permutes
below are views and no copy is made.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..parallel.spatial import windowed


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


# ---- on a column window (the width-split forward, parallel/spatial.py) ----

def bilinear_taps(w_in: int, w_out: int, a: int, b: int, dtype: torch.dtype = torch.float32,
                  device=None):
    """torch's half-pixel source columns of output columns [a, b) of a
    ``w_in`` → ``w_out`` bilinear resize of a ``dtype`` map, in its
    arithmetic type (float64 for float64, else float32): (i0, i1, λ0, λ1),
    column i0 weighted λ0 and i1 = min(i0 + 1, w_in − 1) weighted λ1, the
    source ``(o + 0.5)·(w_in / w_out) − 0.5`` clamped at 0."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    scale = torch.tensor(float(w_in), dtype=acc) / w_out
    src = ((torch.arange(a, b, dtype=acc) + 0.5) * scale - 0.5).clamp_min(0.0)
    i0 = src.long()
    l1 = src - i0
    i1 = i0 + (i0 < w_in - 1).long()
    return tuple(t.to(device) for t in (i0, i1, 1.0 - l1, l1))


def bilinear_reads(w_in: int, w_out: int,
                   dtype: torch.dtype = torch.float32) -> Callable[[int, int], Tuple[int, int]]:
    """(a, b) → [lo, hi): the input columns output columns [a, b) of a
    ``w_in`` → ``w_out`` bilinear resize of a ``dtype`` map tap."""
    def reads(a: int, b: int) -> Tuple[int, int]:
        i0, i1, _, _ = bilinear_taps(w_in, w_out, a, b, dtype)
        return int(i0[0]), int(i1[-1]) + 1
    return reads


def resize_bilinear_window(x: torch.Tensor, lo: int, w_in: int, size: Tuple[int, int],
                           a: int, b: int) -> torch.Tensor:
    """Output columns [a, b) of ``resize_bilinear(whole, size)`` of a map
    ``w_in`` wide, from ``x`` (B, H, w, C), its input columns [lo, lo + w)
    (``bilinear_reads``): the columns blended with the global source map
    (``bilinear_taps``), then the rows by ``F.interpolate``, in torch's
    arithmetic type and order (the width's blend inside the height's), cast
    back to ``x``'s dtype."""
    i0, i1, l0, l1 = bilinear_taps(w_in, size[1], a, b, x.dtype, x.device)
    xf = x.to(l0.dtype)
    cols = xf.index_select(2, i0 - lo) * l0[:, None] + xf.index_select(2, i1 - lo) * l1[:, None]
    y = F.interpolate(cols.permute(0, 3, 1, 2), size=(size[0], b - a), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear_cols(x: torch.Tensor, width: int, size: Tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear`` of a width-split map: from this rank's columns
    ``x`` (B, H, w, C) of a map ``width`` wide, this rank's columns of the
    resize to ``size`` (``parallel/spatial.py``'s rule), each from the
    input columns it taps."""
    y = windowed(x, width, size[1], bilinear_reads(width, size[1], x.dtype),
                 lambda xw, lo, hi, a, b: resize_bilinear_window(xw, lo, width, size, a, b),
                 dim=2)
    return x.new_zeros((x.shape[0], size[0], 0, x.shape[3])) if y is None else y


def bicubic_reads(level: int, w_in: int) -> Callable[[int, int], Tuple[int, int]]:
    """(a, b) → [lo, hi): the window of a ``w_in``-wide map whose
    ``downsample_bicubic_direct`` at ``level`` (f = 2^level, f ≥ 2) gives
    output columns [a, b) as the whole map's: output o taps f·o + f/2 − 2 …
    f·o + f/2 + 1, so lo, a multiple of f (local output o − lo/f is global
    o, at the same source offsets), leaves the local clamp of the left
    taps to the outputs before a, and hi ≥ f·b covers output b − 1;
    clipped to the map, whose own clamp then holds."""
    f = 1 << level

    def reads(a: int, b: int) -> Tuple[int, int]:
        return max(0, f * (a - 1)), min(w_in, max(f * b, f * (b - 1) + f // 2 + 2))
    return reads


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``adaptive_avg_pool2d`` on an NHWC tensor (JAX
    ``ops/interpolate.py::adaptive_avg_pool``, SwiftNet's SPP grids): output
    cell i averages rows ``[floor(i·H/o), ceil((i+1)·H/o))``, so windows are
    unequal where o does not divide H and overlap where o exceeds H."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), tuple(out_hw))
    return y.permute(0, 2, 3, 1)
