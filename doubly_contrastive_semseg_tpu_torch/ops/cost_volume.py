"""Stereo cost volumes and the soft-argmin disparity — port of the JAX
package's ``ops/cost_volume.py`` (reference ``network/cost.py:5-76``,
``network/estimation.py:6-33``). Plain PyTorch: the JAX functions are XLA,
not Pallas kernels.

Layout: features are NCHW (B, C, H, W), as the port's trunks return them.
The correlation volume is (B, D, H, W): the disparity axis is the channel
axis the aggregation's convolutions read (JAX's (B, H, W, D) with D last).
The difference and concat volumes are NCDHW, (B, C, D, H, W) and
(B, 2C, D, H, W), the layout of torch's 3-D convolutions (JAX's
(B, H, W, D, C)), in ``channels_last_3d`` memory. Disparity ``d`` pairs
left column x with right column x − d, zero where x − d < 0.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def _shift_right_img(right: torch.Tensor, d: int) -> torch.Tensor:
    """(…, W) right features shifted by disparity d: zeros where x − d < 0."""
    if d == 0:
        return right
    return F.pad(right, (d, 0))[..., :right.shape[-1]]


def _tile_width(w: int) -> int:
    """JAX's tile: the 8-aligned divisor of W nearest 64 (up to 512), or
    the whole row where W has none."""
    best = None
    for cand in range(8, min(w, 512) + 1, 8):
        if w % cand == 0 and (best is None or abs(cand - 64) < abs(best - 64)):
            best = cand
    return w if best is None else best


def correlation_cost_volume(left: torch.Tensor, right: torch.Tensor,
                            max_disp: int) -> torch.Tensor:
    """(B, C, H, W) × 2 → (B, D, H, W): the channel mean of left · d-shifted
    right (reference ``cost.py:25-35``, 'correlation'), in ``left``'s dtype.

    Computed as JAX's band form for every D: each T-wide tile of a row is
    matched against the T + D − 1 right columns it can see in one batched
    product (f32 sums), and the band ``out[x, d] = G[x, x − d]`` is read off
    by the flat-reshape diagonal trick (row t of the (T, M + 1) view of the
    padded (T, M) product starts at diagonal t). JAX takes a per-d
    shift-and-mean for D < 16 or D > W; the values are the same."""
    b, c, h, w = left.shape
    d = max_disp
    t = _tile_width(w)
    m, nb = t + d - 1, w // t
    lt = left.permute(0, 2, 3, 1)                                   # (B, H, W, C)
    # Rp[x + d − 1] = R[x]: columns left of the image dot to 0
    rp = F.pad(right, (d - 1, 0)).permute(0, 2, 3, 1)               # (B, H, W+D−1, C)
    lb = lt.reshape(b, h, nb, t, c)
    rb = rp.unfold(2, m, t)                                         # (B, H, nb, C, M)
    g = torch.matmul(lb, rb).float() / c                            # (B, H, nb, T, M)
    flat = F.pad(g.reshape(b, h, nb, t * m), (0, t))
    band = flat.reshape(b, h, nb, t, m + 1)[..., :d]                # [t, k] = G[t, t + k]
    out = band.flip(-1).reshape(b, h, w, d)                         # [x, dd] = G[x, x − dd]
    return out.to(left.dtype).permute(0, 3, 1, 2)


def _volume_3d(left: torch.Tensor, right: torch.Tensor, max_disp: int,
               concat: bool) -> torch.Tensor:
    """The difference (``concat`` false) or concat volume, written plane by
    plane into one (B, D, H, W, C') tensor and returned as its (B, C', D,
    H, W) view, ``channels_last_3d``: the layout cuDNN's 3-D convolutions
    take, and no second copy of the volume is ever held."""
    b, c, h, w = left.shape
    lt, rt = left.permute(0, 2, 3, 1), right.permute(0, 2, 3, 1)    # NHWC views
    vol = left.new_empty((b, max_disp, h, w, 2 * c if concat else c))
    for d in range(max_disp):
        plane, m = vol[:, d], min(d, w)
        if concat:
            plane[..., :c] = lt
            plane[:, :, :m, c:] = 0
            plane[:, :, m:, c:] = rt[:, :, :w - m]
        else:
            plane.copy_(lt)
            plane[:, :, m:] -= rt[:, :, :w - m]
    return vol.permute(0, 4, 1, 2, 3)


def difference_cost_volume(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """(B, C, D, H, W): left − d-shifted right (reference 'difference')."""
    return _volume_3d(left, right, max_disp, concat=False)


def concat_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """(B, 2C, D, H, W): left and d-shifted right on the channel axis
    (reference 'concat')."""
    return _volume_3d(left, right, max_disp, concat=True)


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                feature_similarity: str = "correlation") -> torch.Tensor:
    if feature_similarity == "correlation":
        return correlation_cost_volume(left, right, max_disp)
    if feature_similarity == "difference":
        return difference_cost_volume(left, right, max_disp)
    if feature_similarity == "concat":
        return concat_cost_volume(left, right, max_disp)
    raise NotImplementedError(feature_similarity)


def cost_volume_pyramid(left_feats: Sequence[torch.Tensor], right_feats: Sequence[torch.Tensor],
                        max_disp: int,
                        feature_similarity: str = "correlation") -> List[torch.Tensor]:
    """A volume a scale, the disparity range halved at each (reference
    ``CostVolumePyramid``, ``cost.py:55-76``)."""
    return [cost_volume(lf, rf, max_disp // (2 ** i), feature_similarity)
            for i, (lf, rf) in enumerate(zip(left_feats, right_feats))]


def soft_argmin_disparity(cost: torch.Tensor, match_similarity: bool = True) -> torch.Tensor:
    """(B, D, H, W) → (B, H, W) float32: the expected disparity under the
    softmax over D, taken in float32 (reference ``estimation.py:6-33``).
    A matching-cost volume (``match_similarity=False``) is negated first."""
    logits = (cost if match_similarity else -cost).float()
    prob = torch.softmax(logits, dim=1)
    d = torch.arange(cost.shape[1], dtype=torch.float32, device=cost.device)
    return (prob * d[:, None, None]).sum(dim=1)
