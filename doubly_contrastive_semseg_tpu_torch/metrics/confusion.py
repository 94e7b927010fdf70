"""On-device streaming confusion matrices — port of the JAX package's
``metrics/confusion.py``.

The reference pulls every prediction to the host and runs ``np.bincount``
per batch (``metrics/stream_metrics.py:330-342``). Here each matrix is a
histogram over the flat cell index ``gt·C + pred`` (``w·C² + gt·C + pred``
per weather), taken on the tensors' device, so validation runs without a
host sync and the matrices cross to the host once. The JAX package forms the
same counts as one-hot products for the TPU's matrix unit; the B·H·W × C
one-hot matrices are never built here.

``torch.histc`` with an explicit range is the histogram: ``torch.bincount``
on a CUDA tensor reads the input's max back to the host to size its output,
a sync in the middle of the eval step. Cell indices are integers below
2²⁴, exact in float32; bins are centred on them (edges at k ± 0.5), and
the dropped pixels get index -1, outside the range, which histc ignores.
Counts are float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _histogram(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of each integer in [0, n) among ``idx`` (others ignored), f32."""
    return torch.histc(idx.reshape(-1).float(), bins=n, min=-0.5, max=n - 0.5)


def _cells(gt: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Flat (gt, pred) cell of each pixel, -1 where gt is outside
    [0, num_classes); predictions are clipped into range."""
    gt = gt.long()
    valid = (gt >= 0) & (gt < num_classes)
    cell = gt * num_classes + pred.long().clamp(0, num_classes - 1)
    return torch.where(valid, cell, torch.full_like(cell, -1))


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(C, C) counts with rows = ground truth, cols = prediction. Pixels
    outside [0, num_classes) (ignore = 255) are dropped, the reference's
    mask at ``stream_metrics.py:331``."""
    cells = _cells(gt, pred, num_classes)
    return _histogram(cells, num_classes * num_classes).reshape(num_classes, num_classes)


def confusion_matrix_per_weather(gt: torch.Tensor, pred: torch.Tensor,
                                 weather: torch.Tensor, num_classes: int,
                                 weather_num: int) -> torch.Tensor:
    """(W, C, C): per-weather-condition confusion matrices of (B, H, W)
    label maps and (B,) weather ids (reference ``stream_metrics.py:341-342``
    keeps a dict of per-weather matrices). An image whose weather id is
    outside [0, W) counts nowhere, as its zero one-hot row in JAX."""
    b = gt.shape[0]
    cc = num_classes * num_classes
    cells = _cells(gt, pred, num_classes).reshape(b, -1)
    w = weather.reshape(b, 1).long()
    keep = (cells >= 0) & (w >= 0) & (w < weather_num)
    idx = torch.where(keep, w * cc + cells, torch.full_like(cells, -1))
    return _histogram(idx, weather_num * cc).reshape(weather_num, num_classes, num_classes)


def weather_confusion_matrix(gt_weather: torch.Tensor, weather_logits: torch.Tensor,
                             weather_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """((W, W) confusion, batch top-1 accuracy) for the weather classifier
    (reference ``stream_metrics.py:345-352``). A ground truth outside
    [0, W) counts in no row, and as a miss in the accuracy."""
    pred = weather_logits.argmax(-1).reshape(-1)
    gt = gt_weather.reshape(-1).long()
    valid = (gt >= 0) & (gt < weather_num)
    idx = torch.where(valid, gt * weather_num + pred, torch.full_like(gt, -1))
    cm = _histogram(idx, weather_num * weather_num).reshape(weather_num, weather_num)
    return cm, (pred == gt).float().mean()


def iou_from_confusion(cm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """mIoU / accuracies from a confusion matrix (reference
    ``stream_metrics.py:404-427`` ``get_results``). NaN-safe like
    ``np.nanmean``: a class absent from both gt and pred has IoU NaN and
    drops out of the means."""
    diag = torch.diagonal(cm)
    rows = cm.sum(dim=1)
    cols = cm.sum(dim=0)
    iu = diag / (rows + cols - diag)
    total = cm.sum()
    freq = rows / total
    return {
        "Overall Acc": diag.sum() / total,
        "Mean Acc": torch.nanmean(diag / rows),
        "FreqW Acc": torch.nansum(torch.where(freq > 0, freq * iu, torch.zeros_like(iu))),
        "Mean IoU": torch.nanmean(iu),
        "Class IoU": iu,
    }
