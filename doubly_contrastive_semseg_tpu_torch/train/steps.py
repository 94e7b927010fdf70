"""The train and eval steps — port of the JAX package's ``train/steps.py``
(``ingest_batch``, ``make_train_step``, ``make_eval_step``,
``init_eval_accum``; reference ``trainer.py:62-215`` train,
``trainer.py:303-402`` validate).

A batch is a dict of tensors on the model's device: ``left`` (2B or B,
H, W, 3) images (uint8 or float; two views stacked for a SupCon
criterion), ``label`` (B, H, W) with 255 holes, ``label_distance_weight``
(B, H, W) EDT weights, ``weather`` (B,), ``class_weight`` (C,). The eval
step takes ``left`` and, where present, ``label`` and ``weather``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses import compute_total_loss, weather_classifier_metrics
from ..metrics.confusion import (confusion_matrix, confusion_matrix_per_weather,
                                 weather_confusion_matrix)
from ..models.blocks import set_dropout_generator
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
    loss, components, model outputs). ``generator`` draws, in order, the
    dropout masks of the forward (ASPP's, ENet's; JAX's ``rng_drop``) and
    the pixel-contrast anchors; the trainer keys it by the update count.
    ``use_kernel`` forces the contrastive losses' route (None: by size, as
    in JAX)."""
    batch = ingest_batch(batch)
    set_dropout_generator(model, generator)
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


def make_eval_step(model, cfg) -> Callable:
    """Returns ``eval_step(batch, accum) -> (preds, accum)``: the eval-mode
    forward under ``torch.no_grad()``, ``preds`` the (B, H, W) int32 argmax
    of ``outputs["seg"]``, and a new ``accum`` (see ``init_eval_accum``)
    with the batch's confusion matrices added on the model's device,
    without a host sync (the reference pulls preds to numpy every batch,
    ``trainer.py:349-354``). The weather accumulators are updated on a
    weather dataset for a batch with ``weather``, as in JAX; at eval there
    is no two-view split, so ``weather_logits`` is the reference's
    ``weather_clf(fine_feat)`` (``trainer.py:345-347``)."""
    c, w = cfg.num_classes, cfg.weather_num
    on_weather = cfg.dataset in WEATHER_DATASETS

    @torch.no_grad()
    def eval_step(batch: Dict, accum: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model.eval()
        batch = ingest_batch(batch)
        outputs = model(batch["left"], return_supcon_feature=False)
        preds = outputs["seg"].argmax(-1).to(torch.int32)
        accum = dict(accum)
        if "label" in batch:
            labels = batch["label"]
            accum["cm"] = accum["cm"] + confusion_matrix(labels, preds, c)
            if on_weather and "weather" in batch:
                accum["cm_weather_sem"] = accum["cm_weather_sem"] + \
                    confusion_matrix_per_weather(labels, preds, batch["weather"], c, w)
        if on_weather and "weather" in batch:
            wcm, wacc = weather_confusion_matrix(batch["weather"],
                                                 outputs["weather_logits"], w)
            accum["cm_weather"] = accum["cm_weather"] + wcm
            accum["weather_acc_sum"] = accum["weather_acc_sum"] + wacc
            accum["n_batches"] = accum["n_batches"] + 1
        return preds, accum

    return eval_step


def init_eval_accum(cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed eval accumulators on ``device``, float32 as in JAX: ``cm``
    (C, C), ``cm_weather_sem`` (W, C, C), ``cm_weather`` (W, W),
    ``weather_acc_sum`` and ``n_batches`` scalars. On the card unless
    ``device`` asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_eval_accum: CUDA is not available; pass "
                           "device='cpu' to evaluate on the CPU")
    c, w = cfg.num_classes, cfg.weather_num

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"cm": zeros(c, c), "cm_weather_sem": zeros(w, c, c),
            "cm_weather": zeros(w, w), "weather_acc_sum": zeros(),
            "n_batches": zeros()}
