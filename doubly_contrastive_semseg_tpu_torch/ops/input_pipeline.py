"""Input normalisation, the image pyramid and the ×4 upsample + argmax.

Counterpart of the JAX package's ``ops/input_pipeline.py``. The space-to-depth
packing there (and its dy-major / c-major channel orders) is a layout device
for the TPU's 128-lane vector unit: the port's stem kernel reads the dense
NHWC level directly, so only the mapping between the dense 7×7 stem kernel
and the JAX model's s2d form is kept, for the weight converter.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .interpolate import downsample_bicubic_direct

# ImageNet-scale normalisation constants of the reference backbone
# (network/weathernet.py:37-38)
IMAGENET_MEAN = (73.15, 82.90, 72.3)
IMAGENET_STD = (47.67, 48.49, 47.73)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels → float32 ``(x - IMAGENET_MEAN) / IMAGENET_STD``."""
    m = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=image.device)
    s = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=image.device)
    return (image.float() - m) / s


def build_pyramid(image: torch.Tensor, levels: int,
                  dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Normalised pyramid [x, x/2, x/4, ...] of dense contiguous NHWC levels,
    each computed directly from the full image. Normalisation and bicubic
    run in float32 and each level is then cast to ``dtype`` (the JAX side also
    accumulates its pyramid convolutions in float32)."""
    xn = normalize(image)
    return [downsample_bicubic_direct(xn, lv).contiguous().to(dtype)
            for lv in range(levels)]


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
