"""The train step — port of the JAX package's ``train/steps.py``
(``ingest_batch``, ``make_train_step``; reference ``trainer.py:62-215``).

A batch is a dict of tensors on the model's device: ``left`` (2B or B,
H, W, 3) images (uint8 or float; two views stacked for a SupCon
criterion), ``label`` (B, H, W) with 255 holes, ``label_distance_weight``
(B, H, W) EDT weights, ``weather`` (B,), ``class_weight`` (C,). The eval
step and its confusion matrices come with the metrics slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses import compute_total_loss, weather_classifier_metrics
from .optimizer import set_lr
from .state import TrainState

# datasets with a weather label, whose head is monitored (JAX steps.py:49)
WEATHER_DATASETS = ("acdc", "acdc_city", "synthetic")


def ingest_batch(batch: Dict) -> Dict:
    """Widens the loader's narrow wire types: integer images → float32,
    labels → int32 (both exact). Float images pass through."""
    out = dict(batch)
    for k in ("left", "right"):
        if k in out and not out[k].is_floating_point():
            out[k] = out[k].float()
    if "label" in out and out["label"].dtype != torch.int32:
        out["label"] = out["label"].to(torch.int32)
    return out


def compute_loss(model, cfg, batch: Dict, generator: Optional[torch.Generator],
                 use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The forward of one train step in the model's current mode: (total
    loss, components, model outputs). ``use_kernel`` forces the contrastive
    losses' route (None: by size, as in JAX)."""
    batch = ingest_batch(batch)
    outputs = model(batch["left"], return_supcon_feature=cfg.use_supcon)
    total, comps = compute_total_loss(cfg, outputs, batch, batch["class_weight"],
                                      generator, use_kernel=use_kernel)
    return total, comps, outputs


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``train_step(state, batch, generator) -> metrics``: forward
    in training mode, backward, one optimizer update at the scheduled lr,
    ``state.step`` += 1. The metrics are the loss components (detached)
    and, on a weather dataset, the weather head's CE and accuracy, which
    stay out of the total (reference ``trainer.py:205-206``)."""
    on_weather = cfg.dataset in WEATHER_DATASETS

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, comps, outputs = compute_loss(model, cfg, batch, generator)
        total.backward()
        set_lr(optimizer, cfg, state.step)
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        if on_weather:
            with torch.no_grad():
                w_ce, w_acc = weather_classifier_metrics(outputs["weather_logits"],
                                                         batch["weather"])
            metrics["weather_loss"], metrics["weather_clf_acc"] = w_ce, w_acc
        return metrics

    return train_step
