"""Disparity error metrics — port of the JAX package's
``metrics/disparity.py`` (reference ``metrics/disparity_metric.py:7-47``):
the end-point error, D1 (KITTI's: error above 3 px and above 5 % of the
ground truth) and the share above a threshold, each a mean over the pixels
with ground truth (``gt > 0`` unless ``valid`` is given); 0 when no pixel
is valid. Each returns a scalar tensor on the inputs' device."""

from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum()
    return torch.where(n > 0, torch.where(mask, x, 0.0).sum() / n.clamp_min(1), 0.0)


def epe_metric(pred: torch.Tensor, gt: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = (gt > 0) if valid is None else valid
    return _masked_mean((pred - gt).abs(), valid)


def d1_metric(pred: torch.Tensor, gt: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = (gt > 0) if valid is None else valid
    err = (pred - gt).abs()
    bad = (err > 3.0) & (err > 0.05 * gt)
    return _masked_mean(bad.float(), valid)


def thres_metric(pred: torch.Tensor, gt: torch.Tensor, thres: float,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    valid = (gt > 0) if valid is None else valid
    return _masked_mean(((pred - gt).abs() > thres).float(), valid)
