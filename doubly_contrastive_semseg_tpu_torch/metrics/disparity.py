"""Disparity error metrics — port of the JAX package's
``metrics/disparity.py`` (reference ``metrics/disparity_metric.py:7-47``):
the end-point error, D1 (KITTI's: error above 3 px and above 5 % of the
ground truth) and the share above a threshold, each a mean over the pixels
with ground truth (``gt > 0`` unless ``valid`` is given); 0 when no pixel
is valid. Each returns a scalar tensor on the inputs' device. The means
come from ``disparity_sums``, whose sums add over the ranks of a batch."""

from __future__ import annotations

from typing import Optional

import torch


def disparity_sums(pred: torch.Tensor, gt: torch.Tensor, thres: float = 1.0,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(4,) float32 over the valid pixels: Σ|pred − gt|, the D1 outliers,
    the errors above ``thres`` and the pixels' count."""
    valid = (gt > 0) if valid is None else valid
    err = (pred - gt).abs()
    bad = (err > 3.0) & (err > 0.05 * gt)
    return torch.stack([torch.where(valid, x, 0.0).sum()
                        for x in (err, bad.float(), (err > thres).float())]
                       + [valid.sum().float()])


def metrics_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """(..., 3) EPE, D1 and >thres share from ``disparity_sums``' (..., 4),
    0 where no pixel is valid."""
    n = sums[..., 3:]
    return torch.where(n > 0, sums[..., :3] / n.clamp_min(1), 0.0)


def epe_metric(pred: torch.Tensor, gt: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return metrics_from_sums(disparity_sums(pred, gt, valid=valid))[0]


def d1_metric(pred: torch.Tensor, gt: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return metrics_from_sums(disparity_sums(pred, gt, valid=valid))[1]


def thres_metric(pred: torch.Tensor, gt: torch.Tensor, thres: float,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return metrics_from_sums(disparity_sums(pred, gt, thres, valid))[2]
