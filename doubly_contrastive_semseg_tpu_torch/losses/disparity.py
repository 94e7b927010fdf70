"""Disparity losses — port of the JAX package's ``losses/disparity.py``
(reference ``utils/loss.py:478-565``, ``DisparityLosses`` and
``get_smooth_loss``): the pyramid-weighted smooth-L1 over the valid
ground-truth pixels, and the edge-aware smoothness regulariser, which no
step calls.

Disparities are (B, H, W) float32 in pixels of their own resolution; a
coarser prediction is resized bilinearly to the ground truth's size and
multiplied by the width ratio, as JAX does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.interpolate import resize_bilinear
from ..parallel import all_sum, global_value

# the loss weight of each prediction, by the pyramid's length (reference
# utils/init_trainer.py:227-233)
PYRAMID_WEIGHTS = {
    5: (1 / 3, 2 / 3, 1.0, 1.0, 1.0),
    4: (1 / 3, 2 / 3, 1.0, 1.0),
    3: (1.0, 1.0, 1.0),
    2: (1.0, 1.0),
    1: (1.0,),
}


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def disparity_loss(pred_pyramid: Sequence[torch.Tensor], gt_disp: torch.Tensor, *,
                   max_disp: int = 192, alphas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k w_k · the mean smooth-L1 over the pixels with 0 < gt < ``max_disp``
    (``n`` at least 1); a prediction narrower than the ground truth is
    resized to it and scaled by ``gt_w / pred_w``; ``alphas`` (B, H, W)
    multiplies the error."""
    weights = PYRAMID_WEIGHTS[len(pred_pyramid)]
    valid = (gt_disp > 0) & (gt_disp < max_disp)
    n = all_sum(valid.sum()).clamp_min(1)   # the global batch's, with several ranks
    total = 0.0
    for w, pred in zip(weights, pred_pyramid):
        if pred.shape[-1] != gt_disp.shape[-1]:
            scale = gt_disp.shape[-1] / pred.shape[-1]
            pred = resize_bilinear(pred[..., None], tuple(gt_disp.shape[-2:]))[..., 0] * scale
        err = _smooth_l1(pred - gt_disp)
        if alphas is not None:
            err = err * alphas
        total = total + w * torch.where(valid, err, 0.0).sum() / n
    return global_value(total)


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of ``disp`` (B, H, W) or (B, H, W,
    1) against ``img`` (B, H, W, C) (reference ``loss.py:552-564``)."""
    d = disp[..., None] if disp.dim() == 3 else disp
    gx = (d[:, :, :-1] - d[:, :, 1:]).abs()
    gy = (d[:, :-1, :] - d[:, 1:, :]).abs()
    ix = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(dim=-1, keepdim=True)
    iy = (img[:, :-1, :] - img[:, 1:, :]).abs().mean(dim=-1, keepdim=True)
    return (gx * torch.exp(-ix)).mean() + (gy * torch.exp(-iy)).mean()
