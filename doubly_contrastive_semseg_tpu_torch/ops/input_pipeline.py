"""Input layouts, normalisation, the image pyramid and the ×4 upsample +
argmax.

Counterpart of the JAX package's ``ops/input_pipeline.py``. The model takes
an image in any of JAX's three layouts: NHWC (B, H, W, 3), planar
(B, 3, H, W), and space-to-depth (B, H/2, W/2, 12) packed by JAX's
``s2d_pack``. The space-to-depth packing (and its dy-major / c-major channel
orders) is a layout device for the TPU's 128-lane vector unit: the port's
stem kernel reads the dense NHWC level, so ``to_nhwc`` unpacks the other
two layouts on the device first (a permutation, exact), and only the
mapping between the dense 7×7 stem kernel and the JAX model's s2d form is
kept, for the weight converter.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import windowed
from .interpolate import bicubic_reads, downsample_bicubic_direct

# ImageNet-scale normalisation constants of the reference backbone
# (network/weathernet.py:37-38)
IMAGENET_MEAN = (73.15, 82.90, 72.3)
IMAGENET_STD = (47.67, 48.49, 47.73)


def is_planar_image(x) -> bool:
    """(B, 3, H, W) rather than (B, H, W, 3) (JAX ``is_planar_image``)."""
    return x.ndim == 4 and x.shape[1] == 3 and x.shape[3] not in (3, 12)


def is_s2d_image(x) -> bool:
    """(B, H/2, W/2, 12): an image packed into space-to-depth(2) cells by
    JAX's ``s2d_pack`` (JAX ``is_s2d_image``)."""
    return x.ndim == 4 and x.shape[-1] == 12


def image_hw(x) -> Tuple[int, int]:
    """(H, W) of an image in any of the three layouts (JAX ``image_hw``)."""
    if is_planar_image(x):
        return (x.shape[2], x.shape[3])
    if is_s2d_image(x):
        return (2 * x.shape[1], 2 * x.shape[2])
    return (x.shape[1], x.shape[2])


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An image in any of the three layouts → (B, H, W, 3) on its device.
    A planar image is transposed; an s2d image, channel ``c*4 + i0*2 + j0``
    of cell (y, x) holding pixel (2y + i0, 2x + j0) of channel c, is
    unpacked. Both come out contiguous, so that every layout of one image
    runs the same arithmetic; an NHWC image is returned as it is."""
    if is_planar_image(x):
        return x.permute(0, 2, 3, 1).contiguous()
    if is_s2d_image(x):
        b, h2, w2, _ = x.shape
        return (x.reshape(b, h2, w2, 3, 2, 2).permute(0, 1, 4, 2, 5, 3)
                .reshape(b, 2 * h2, 2 * w2, 3).contiguous())
    return x


def normalize(image: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Pixels in any layout (``to_nhwc``) → (B, H, W, 3) float32
    ``(x - mean) / std``, the ImageNet-scale constants unless given."""
    image = to_nhwc(image)
    m = torch.tensor(mean, dtype=torch.float32, device=image.device)
    s = torch.tensor(std, dtype=torch.float32, device=image.device)
    return (image.float() - m) / s


def build_pyramid(image: torch.Tensor, levels: int, dtype: torch.dtype = torch.float32,
                  mean=IMAGENET_MEAN, std=IMAGENET_STD) -> List[torch.Tensor]:
    """Normalised pyramid [x, x/2, x/4, ...] of dense contiguous NHWC levels,
    each computed directly from the full image. Normalisation and bicubic
    run in float32 and each level is then cast to ``dtype`` (the JAX side also
    accumulates its pyramid convolutions in float32). Each level has the
    size the JAX model's space-to-depth(2) pyramid (``fused_pyramid_s2d``)
    gives it, ``pyramid_hw``; where that is larger than the bicubic level,
    the extra row or column is the bicubic formula read with the border
    clamped, as JAX's clamp padding gives it. ``image`` may come in any
    of the three layouts (``to_nhwc``); ``mean`` and ``std`` as ``normalize``'s."""
    image = to_nhwc(image)
    xn = normalize(image, mean, std)
    out = []
    for lv in range(levels):
        hh, ww = pyramid_hw(image.shape[1], image.shape[2], lv)
        pad_h, pad_w = max(0, (hh << lv) - xn.shape[1]), max(0, (ww << lv) - xn.shape[2])
        x = xn
        if pad_h or pad_w:   # replicated pixels: taps past the border read it
            x = F.pad(xn.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                      mode="replicate").permute(0, 2, 3, 1)
        out.append(downsample_bicubic_direct(x, lv)[:, :hh, :ww].contiguous().to(dtype))
    return out


def build_pyramid_cols(image: torch.Tensor, width: int, levels: int,
                       dtype: torch.dtype = torch.float32, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD) -> List[Tuple[torch.Tensor, int]]:
    """``build_pyramid`` of a width-split image: from this rank's columns of
    an NHWC or planar image ``width`` wide (``parallel/spatial.py``), each
    level's (this rank's columns, the level's width). The level sizes are
    the whole image's ``pyramid_hw``; each level reads the normalised
    columns ``bicubic_reads`` gives, and the replicate pad of an extra
    column (or row) is made only where the window meets the image's right
    (or bottom) edge. Equal to the whole image's levels column for column."""
    if is_s2d_image(image):
        raise ValueError("build_pyramid_cols: a width-split image is NHWC or planar pixels; "
                         "the columns of s2d cells are not the image's")
    xn = normalize(image, mean, std)
    h = xn.shape[1]
    out = []
    for lv in range(levels):
        hh, ww = pyramid_hw(h, width, lv)
        f = 1 << lv

        def level_cols(xw, lo, hi, a, b, lv=lv, hh=hh, ww=ww, f=f):
            pad_h = max(0, (hh << lv) - h)
            pad_w = max(0, (ww << lv) - width) if hi == width else 0
            if pad_h or pad_w:
                xw = F.pad(xw.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                           mode="replicate").permute(0, 2, 3, 1)
            y = downsample_bicubic_direct(xw, lv)
            return y[:, :hh, a - lo // f:b - lo // f].contiguous().to(dtype)

        reads = (lambda a, b: (a, b)) if lv == 0 else bicubic_reads(lv, width)
        y = windowed(xn, width, ww, reads, level_cols, dim=2)
        out.append((xn.new_zeros((xn.shape[0], hh, 0, 3), dtype=dtype) if y is None else y, ww))
    return out


def pyramid_hw(h: int, w: int, level: int) -> Tuple[int, int]:
    """(height, width) of pyramid level ``level`` of an (h, w) image in the
    JAX model, whose levels are s2d(2) cells built from the h/2 × w/2 cells
    of level 0: level 1 has ⌈(h/2)/2⌉ cells (its convolution reads clamp
    padding), level L ≥ 2 has ⌊(h/2)/2^L⌋ (no padding). Two pixels a cell;
    equal to ⌊h/2^L⌋ whenever h is a multiple of 2^(L+1)."""
    h2, w2 = h // 2, w // 2
    if level == 0:
        return 2 * h2, 2 * w2
    if level == 1:
        return 2 * -(-h2 // 2), 2 * -(-w2 // 2)
    return 2 * (h2 >> level), 2 * (w2 >> level)


def upsample4x_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) logits → (B, 4h, 4w) int32 argmax of their ×4 bilinear
    upsample (align_corners=False); ties keep the first class."""
    up = F.interpolate(logits.permute(0, 3, 1, 2), scale_factor=4,
                       mode="bilinear", align_corners=False)
    return up.argmax(dim=1).to(torch.int32)


# ---- dense 7×7/s2 stem kernel ↔ the JAX model's s2d 4×4/s1 form ----------

def s2d_stem_geometry(k: int) -> Tuple[int, Tuple[int, int]]:
    """(s2d kernel size, (pad_left, pad_right)) of a k×k/stride-2/pad-k//2
    conv re-expressed over the space-to-depth(2) grid."""
    p = k // 2
    qs = [(ty - p) >> 1 for ty in range(k)]
    return max(qs) - min(qs) + 1, (-min(qs), max(qs))


def _s2d_slots(k: int):
    """Yields (ty, tx, ka, kb, phase) for every dense tap: dense row
    ``2o - p + ty`` is s2d cell ``o + ka - pad`` at in-cell phase ``i0``, and
    channel ``ci`` of that tap sits at s2d channel ``ci * 4 + phase``."""
    p = k // 2
    _, (pl_, _) = s2d_stem_geometry(k)
    for ty in range(k):
        ka, i0 = ((ty - p) >> 1) + pl_, (ty - p) & 1
        for tx in range(k):
            kb, j0 = ((tx - p) >> 1) + pl_, (tx - p) & 1
            yield ty, tx, ka, kb, i0 * 2 + j0


def stem_dense_kernel_from_s2d(w_s2d: np.ndarray, k: int = 7) -> np.ndarray:
    """The JAX model's s2d stem kernel (k', k', 4C, O), channel order
    ``c * 4 + phase``, → the dense (k, k, C, O) kernel it holds. Inverse of
    the JAX ``stem_s2d_kernel_from_dense``: it reads back the k·k·C live
    slots of ``stem_s2d_mask`` and drops the structurally zero ones."""
    _, _, cc, o = w_s2d.shape
    c = cc // 4
    dense = np.zeros((k, k, c, o), w_s2d.dtype)
    ci = np.arange(c)
    for ty, tx, ka, kb, phase in _s2d_slots(k):
        dense[ty, tx] = w_s2d[ka, kb, ci * 4 + phase]
    return dense


def s2d_kernel_to_dense(w_s2d: np.ndarray) -> np.ndarray:
    """An s2d(2) stem kernel with every slot live (k', k', 4C, O), channel
    order ``c * 4 + phase``, → the dense (2k', 2k', C, O) stride-2 kernel it
    is: slot (ka, kb, c·4 + i0·2 + j0) is dense tap (2ka + i0, 2kb + j0).
    Over the s2d grid padded (pl, pr) cells it reads the dense image padded
    (2·pl, 2·pr + 1) pixels (``s2d_dense_padding``). The JAX pyramids whose
    stem is unmasked (MobileNetV2 over ``s2d_stem_geometry(7)``,
    EfficientNet-B0 over ``s2d_stem_geometry(3)``) hold such kernels."""
    k, _, cc, o = w_s2d.shape
    c = cc // 4
    return (w_s2d.reshape(k, k, c, 2, 2, o).transpose(0, 3, 1, 4, 2, 5)
            .reshape(2 * k, 2 * k, c, o))


def s2d_dense_padding(k: int) -> Tuple[int, int]:
    """(top/left, bottom/right) pixel padding of the dense stride-2 form
    (``s2d_kernel_to_dense``) of the s2d(2) conv of a k×k stem."""
    _, (pl_, pr_) = s2d_stem_geometry(k)
    return 2 * pl_, 2 * pr_ + 1
