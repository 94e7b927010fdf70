"""Disparity warping — port of the JAX package's ``ops/warp.py`` (reference
``network/warp.py:5-64``): the right view sampled at x − d reconstructs the
left view. The warp is horizontal only, so it is a linear blend of two
column gathers on the width axis, no sampling grid. Plain PyTorch: the JAX
function is XLA, not a Pallas kernel."""

from __future__ import annotations

from typing import Tuple

import torch


def disp_warp(right: torch.Tensor, disp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """right (B, H, W, C) and disp (B, H, W) → (warped, mask), both (B, H,
    W, C): ``warped`` at column x blends ``right``'s columns floor(x − d)
    and the next by the fraction of x − d, and is zero where x − d lies
    outside [0, W − 1], where ``mask`` is 0 (1 elsewhere)."""
    b, h, w, c = right.shape
    xs = torch.arange(w, dtype=torch.float32, device=right.device) - disp   # sample column
    x0 = torch.floor(xs)
    frac = xs - x0
    inside = (xs >= 0) & (xs <= w - 1)
    x0c = x0.clamp(0, w - 1).long()[..., None].expand(b, h, w, c)
    x1c = (x0 + 1).clamp(0, w - 1).long()[..., None].expand(b, h, w, c)
    v0 = torch.gather(right, 2, x0c)
    v1 = torch.gather(right, 2, x1c)
    warped = (1.0 - frac)[..., None] * v0 + frac[..., None] * v1
    mask = inside[..., None].to(right.dtype)
    return warped * mask, mask.expand(warped.shape)
