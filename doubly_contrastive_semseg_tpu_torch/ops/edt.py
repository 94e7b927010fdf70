"""Euclidean distance transforms by jump flooding — port of the JAX
package's ``ops/edt.py`` (reference: ``cv2.distanceTransform`` in the
loader's ``LabelBoundaryTransform``, ``custom_transforms_acdc.py:656-693``).

Jump flooding (JFA) propagates nearest-seed coordinates in O(log N) rounds
of shifted comparisons: each round's step halves (from the largest power of
two below the frame's longer side down to 1), then one more step-1 round
(JFA+1). Each round visits the 8 directions one after another, and each
direction reads the state the previous one left, so the result is that of
the sequence of (round, direction) updates, in JAX's order.

- ``distance_transform``: distance from each True pixel to the nearest
  False one. Plain PyTorch only (no consumer on the card's paths).
- ``nearest_diff_label_distance``: the label-carrying flood, the distance
  from each pixel to the nearest pixel of another label. A CPU tensor takes
  the plain version; a CUDA tensor launches ``csrc/jfa.cu`` once per
  (round, direction) — 88 launches at 768², 64 at 96² — or raises.
- ``label_boundary_weights``: the ``LabelBoundaryTransform`` weights from
  that flood, exp(−d / 2σ) with σ the population std, 0 at ignore.

Every squared distance is a sum of squares of small integers, exact in
float32, and the square root is IEEE, so the kernel, the plain versions and
JAX agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from . import _build

BIG = 1e9
BIG2 = float(np.float32(BIG) * np.float32(BIG))   # float32, as JAX's BIG * BIG
_DIRECTIONS = [(ey, ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1) if (ey, ex) != (0, 0)]


def jfa_rounds(h: int, w: int) -> List[int]:
    """The step of each round for an (h, w) frame: powers of two below
    max(h, w), largest first, then a final step of 1."""
    steps, step = [], 1
    while step < max(h, w):
        steps.append(step)
        step *= 2
    return steps[::-1] + [1]


def jfa_launches(h: int, w: int) -> List[Tuple[int, int]]:
    """(dy, dx) of each (round, direction) update, in JAX's order: dy
    outer, dx inner, each over (−step, 0, step)."""
    return [(ey * s, ex * s) for s in jfa_rounds(h, w) for ey, ex in _DIRECTIONS]


def _grid(shape, device):
    h, w = shape[-2], shape[-1]
    yy = torch.arange(h, dtype=torch.float32, device=device).view(h, 1).expand(shape)
    xx = torch.arange(w, dtype=torch.float32, device=device).view(1, w).expand(shape)
    return yy, xx


def _in_frame(yy, xx, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """Pixels whose neighbour p − (dy, dx) lies inside the frame (JAX masks
    the wrapped-in part of its roll the same way)."""
    valid = torch.ones(yy.shape, dtype=torch.bool, device=yy.device)
    if dy > 0:
        valid = valid & (yy >= dy)
    elif dy < 0:
        valid = valid & (yy < h + dy)
    if dx > 0:
        valid = valid & (xx >= dx)
    elif dx < 0:
        valid = valid & (xx < w + dx)
    return valid


def _shift(t: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """t[p − (dy, dx)] at p, wrapping (``jnp.roll``)."""
    return torch.roll(t, (dy, dx), dims=(-2, -1))


def distance_transform(mask: torch.Tensor) -> torch.Tensor:
    """Euclidean distance from each True pixel to the nearest False pixel,
    0 at False pixels (the semantics of ``cv2.distanceTransform``). mask
    (..., H, W) bool → (..., H, W) float32. Plain PyTorch on any device."""
    h, w = mask.shape[-2], mask.shape[-1]
    yy, xx = _grid(mask.shape, mask.device)
    seed = ~mask
    best_y = torch.where(seed, yy, BIG)
    best_x = torch.where(seed, xx, BIG)
    best_d2 = torch.where(seed, 0.0, torch.tensor(BIG2, dtype=torch.float32,
                                                  device=mask.device))
    for dy, dx in jfa_launches(h, w):
        cand_y, cand_x = _shift(best_y, dy, dx), _shift(best_x, dy, dx)
        valid = _in_frame(yy, xx, dy, dx, h, w)
        cand_d2 = (yy - cand_y) ** 2 + (xx - cand_x) ** 2
        cand_d2 = torch.where(valid & (cand_y < BIG), cand_d2, BIG2)
        better = cand_d2 < best_d2
        best_y = torch.where(better, cand_y, best_y)
        best_x = torch.where(better, cand_x, best_x)
        best_d2 = torch.where(better, cand_d2, best_d2)
    d = torch.sqrt(torch.where(best_d2 >= BIG, 0.0, best_d2))
    return torch.where(mask, d, 0.0)


def nearest_diff_label_distance_reference(labels: torch.Tensor) -> torch.Tensor:
    """Plain version of ``nearest_diff_label_distance``: JAX's rolls and
    selects, direction by direction. The state is one seed a pixel (its
    coordinates, squared distance and label). In each direction a pixel
    (a) adopts its neighbour's stored seed if that seed's label differs
    from its own and it is strictly closer, then (b) the neighbour pixel
    itself, if its label differs and it is strictly closer than the result
    of (a). labels (..., H, W) integers → (..., H, W) float32."""
    h, w = labels.shape[-2], labels.shape[-1]
    yy, xx = _grid(labels.shape, labels.device)
    lbl = labels.to(torch.int32)
    best_y = torch.full(labels.shape, BIG, dtype=torch.float32, device=labels.device)
    best_x = best_y.clone()
    best_d2 = torch.full(labels.shape, BIG2, dtype=torch.float32, device=labels.device)
    best_l = torch.full(labels.shape, -1, dtype=torch.int32, device=labels.device)
    for dy, dx in jfa_launches(h, w):
        valid = _in_frame(yy, xx, dy, dx, h, w)
        # (a) the neighbour's stored seed
        cand_y, cand_x = _shift(best_y, dy, dx), _shift(best_x, dy, dx)
        cand_l = _shift(best_l, dy, dx)
        cand_d2 = (yy - cand_y) ** 2 + (xx - cand_x) ** 2
        ok = valid & (cand_y < BIG) & (cand_l != lbl)
        cand_d2 = torch.where(ok, cand_d2, BIG2)
        better = cand_d2 < best_d2
        best_y = torch.where(better, cand_y, best_y)
        best_x = torch.where(better, cand_x, best_x)
        best_l = torch.where(better, cand_l, best_l)
        best_d2 = torch.where(better, cand_d2, best_d2)
        # (b) the neighbour pixel itself is a seed of its own label
        nb_l = _shift(lbl, dy, dx)
        d2 = float(dy * dy + dx * dx)
        ok2 = valid & (nb_l != lbl) & (d2 < best_d2)
        best_y = torch.where(ok2, yy - dy, best_y)
        best_x = torch.where(ok2, xx - dx, best_x)
        best_l = torch.where(ok2, nb_l, best_l)
        best_d2 = torch.where(ok2, d2, best_d2)
    return torch.sqrt(torch.where(best_d2 >= BIG, 0.0, best_d2))


def nearest_diff_label_distance(labels: torch.Tensor) -> torch.Tensor:
    """Distance from each pixel to the nearest pixel with a different label
    (0 where there is none), by the label-carrying jump flood of JAX
    ``ops/edt.py:88``. labels (..., H, W) integers → (..., H, W) float32.
    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/jfa.cu`` once per (round, direction), counted in
    ``nearest_diff_label_distance.launches``."""
    if labels.device.type == "cpu":
        return nearest_diff_label_distance_reference(labels)
    return jump_flood_cuda(labels)


nearest_diff_label_distance.launches = 0

# label element sizes the kernel reads directly
_LABEL_BYTES = {torch.uint8: 1, torch.int32: 4, torch.int64: 8}


def _lib() -> ctypes.CDLL:
    lib = _build.load("jfa")
    fn = lib.dcss_jfa_step
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def jump_flood_cuda(labels: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/jfa.cu`` on a CUDA tensor, once per (round,
    direction) of ``jfa_launches``, all on the current stream with no host
    sync. The state (seed y, seed x, d², seed label: one float4 a pixel)
    ping-pongs between two buffers; the first launch starts from the empty
    state and the last writes the distances, so a call is exactly
    ``len(jfa_launches(H, W))`` device operations. uint8, int32 and int64
    labels are read as they are; other integer types are cast to int32."""
    if labels.device.type != "cuda":
        raise ValueError(f"jump_flood_cuda: the kernel needs a CUDA tensor, got {labels.device}")
    if labels.dim() < 2:
        raise ValueError(f"jump_flood_cuda: labels must be (..., H, W), got {tuple(labels.shape)}")
    if labels.dtype not in _LABEL_BYTES:
        if labels.dtype.is_floating_point or labels.dtype.is_complex or labels.dtype == torch.bool:
            raise TypeError(f"jump_flood_cuda: integer labels, got {labels.dtype}")
        labels = labels.to(torch.int32)
    labels = labels.contiguous()
    h, w = labels.shape[-2], labels.shape[-1]
    n = labels.numel()
    out = torch.empty(labels.shape, dtype=torch.float32, device=labels.device)
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"jump_flood_cuda: at most 2^31 - 1 pixels, got {n}")
    state = torch.empty((2, n, 4), dtype=torch.float32, device=labels.device)
    lib = _lib()
    steps = jfa_launches(h, w)
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        for i, (dy, dx) in enumerate(steps):
            mode = int(i == 0) | (int(i == len(steps) - 1) << 1)
            status = lib.dcss_jfa_step(
                labels.data_ptr(), _LABEL_BYTES[labels.dtype], state[(i + 1) % 2].data_ptr(),
                state[i % 2].data_ptr(), out.data_ptr(), n, h, w, dy, dx, mode, stream)
            _build.check(lib, status, "nearest_diff_label_distance (jump flood)")
            nearest_diff_label_distance.launches += 1
    return out


def label_boundary_weights(labels: torch.Tensor, num_classes: int,
                           ignore_id: int = 255) -> torch.Tensor:
    """``LabelBoundaryTransform`` on the device (JAX ``ops/edt.py:162``):
    the per-class EDT summed over classes, which at a pixel is its own
    class's distance, the label-carrying flood's; pixels outside
    [0, num_classes) belong to no class and get 0. Then exp(−d / 2σ) with σ
    the population std over each map (1 where it is 0), and 0 at ignore.
    labels (..., H, W) integers → (..., H, W) float32."""
    d = nearest_diff_label_distance(labels)
    in_range = (labels >= 0) & (labels < num_classes)
    summed = torch.where(in_range, d, 0.0)
    std = torch.std(summed, dim=(-2, -1), keepdim=True, correction=0)
    std = torch.where(std == 0, 1.0, std)
    weights = torch.exp(-summed / (2.0 * std))
    return torch.where(labels == ignore_id, 0.0, weights)
