"""The train and eval steps — port of the JAX package's ``train/steps.py``
(``ingest_batch``, ``make_train_step``, ``make_eval_step``,
``make_stereo_train_step``, ``init_eval_accum``; reference
``trainer.py:62-215`` train, ``trainer.py:303-402`` validate,
``utils/loss.py:478-516`` the disparity loss).

A batch is a dict of tensors on the model's device: ``left`` (2B or B,
H, W, 3) images (uint8 or float; two views stacked for a SupCon
criterion), ``label`` (B, H, W) with 255 holes, ``label_distance_weight``
(B, H, W) EDT weights, ``weather`` (B,), ``class_weight`` (C,). The eval
step takes ``left`` and, where present, ``label`` and ``weather``. A stereo
batch holds ``left`` and ``right`` (B, H, W, 3), ``disp`` (B, H, W) float32
(0 where there is no ground truth) and, on a dataset with labels, ``label``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses import compute_total_loss, weather_classifier_metrics
from ..losses.disparity import disparity_loss
from ..losses.focal import cross_entropy_loss
from ..metrics.confusion import (confusion_matrix, confusion_matrix_per_weather,
                                 weather_confusion_matrix)
from ..models.blocks import set_dropout_generator
from ..parallel import all_reduce_grads, local_share, world
from ..utils.profiling import span
from .optimizer import set_lr
from .state import TrainState

# datasets with a weather label, whose head is monitored (JAX steps.py:49)
WEATHER_DATASETS = ("acdc", "acdc_city", "synthetic")
# criteria whose SupCon loss takes the weather as its labels (JAX
# losses/combine.py:90,102,118)
WEATHER_CRITERIA = ("supcon_focal", "supcon_pixelcontrast_focal", "supcon_crossentropy")


def check_weather(cfg) -> None:
    """Raises ``ValueError`` for training that reads a weather label the
    dataset's samples do not carry (``cityscapes``, ``city_lost``): a
    criterion of ``WEATHER_CRITERIA``, or ``--no_host_augment``, whose
    device augmentation takes the weather for its gamma. JAX fails on the
    same runs, with ``KeyError: 'weather'`` at the first step."""
    if cfg.dataset in WEATHER_DATASETS:
        return
    readers = []
    if cfg.criterion in WEATHER_CRITERIA:
        readers.append(f"--criterion {cfg.criterion} (its SupCon labels)")
    if not cfg.host_augment:
        readers.append("--no_host_augment (the device augmentation's gamma)")
    if readers:
        raise ValueError(f"dataset {cfg.dataset!r}: its samples carry no 'weather', which "
                         f"{' and '.join(readers)} reads")


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
    in JAX). The ``dcss.forward`` and ``dcss.loss`` spans."""
    with span("dcss.forward"):
        batch = ingest_batch(batch)
        set_dropout_generator(model, generator)
        outputs = model(batch["left"], return_supcon_feature=cfg.use_supcon)
    with span("dcss.loss"):
        total, comps = compute_total_loss(cfg, outputs, batch, batch["class_weight"],
                                          generator, use_kernel=use_kernel)
    return total, comps, outputs


def _update(optimizer: torch.optim.Optimizer, cfg, state: TrainState, total: torch.Tensor,
           model) -> None:
    """A train step after its loss: the ``dcss.backward`` of ``total``, the
    gradients summed over the ranks (``dcss.allreduce`` where there are
    several), and the ``dcss.optimizer`` update at the scheduled lr;
    ``state.step`` += 1."""
    with span("dcss.backward"):
        total.backward()
    all_reduce_grads(model)
    with span("dcss.optimizer"):
        set_lr(optimizer, cfg, state.step)
        optimizer.step()
    state.step += 1


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``train_step(state, batch, generator) -> metrics``: forward
    in training mode, backward, one optimizer update at the scheduled lr,
    ``state.step`` += 1. The metrics are the loss components (detached)
    and, on a weather dataset, the weather head's CE and accuracy, which
    stay out of the total (reference ``trainer.py:205-206``). With several
    ranks (``parallel/``) ``batch`` is the rank's share of the global batch:
    the losses and metrics are the global batch's, and the gradients are
    summed over the ranks before the update."""
    on_weather = cfg.dataset in WEATHER_DATASETS

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, comps, outputs = compute_loss(model, cfg, batch, generator)
        _update(optimizer, cfg, state, total, model)
        metrics = {k: v.detach() for k, v in comps.items()}
        if on_weather:
            with torch.no_grad():
                w_ce, w_acc = weather_classifier_metrics(outputs["weather_logits"],
                                                         batch["weather"])
            metrics["weather_loss"], metrics["weather_clf_acc"] = w_ce, w_acc
        return metrics

    return train_step


def stereo_loss(model, cfg, batch: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, object]]:
    """The forward of one stereo train step in the model's current mode
    (JAX ``make_stereo_train_step``'s ``loss_fn``): the disparity loss of
    ``[disp_pyramid[0], disp]`` against ``batch["disp"]`` (its default
    ``max_disp`` of 192, whatever the model's), plus the cross-entropy of
    ``seg`` against ``label`` with ``train_semantic`` on a batch with
    labels. Returns (total, {"disp_loss", ["seg_loss"], "total_loss"},
    model outputs). ``PSMNetHGAggregation``'s two earlier costs get no
    loss, as in JAX. The ``dcss.forward`` and ``dcss.loss`` spans."""
    with span("dcss.forward"):
        batch = ingest_batch(batch)
        outputs = model(batch["left"], batch["right"])
    with span("dcss.loss"):
        total = disparity_loss([outputs["disp_pyramid"][0], outputs["disp"]], batch["disp"])
        comps = {"disp_loss": total}
        if cfg.train_semantic and "label" in batch:
            comps["seg_loss"] = cross_entropy_loss(outputs["seg"], batch["label"])
            total = total + comps["seg_loss"]
        comps["total_loss"] = total
    return total, comps, outputs


def make_stereo_train_step(model, cfg, optimizer: torch.optim.Optimizer) -> Callable:
    """Returns ``train_step(state, batch) -> metrics`` for ``StereoDCSS``:
    the training-mode forward of both views (their trunk BN moments span
    the 2B batch, as in JAX), ``stereo_loss``, backward, one optimizer
    update at the scheduled lr, ``state.step`` += 1; the metrics are the
    loss components, detached. No stereo module draws dropout, so the step
    takes no generator where JAX's takes an rng it never reads."""

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, comps, _ = stereo_loss(model, cfg, batch)
        _update(optimizer, cfg, state, total, model)
        return {k: v.detach() for k, v in comps.items()}

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
    ``weather_clf(fine_feat)`` (``trainer.py:345-347``). With several ranks
    ``batch`` is the rank's share of a val batch, which may be empty: the
    accuracy enters weighted by that share and rank 0 alone counts the
    batch, so the sums over the ranks are the one-process ones."""
    c, w = cfg.num_classes, cfg.weather_num
    on_weather = cfg.dataset in WEATHER_DATASETS

    @torch.no_grad()
    def eval_step(batch: Dict, accum: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model.eval()
        batch = ingest_batch(batch)
        if batch["left"].shape[0] == 0:
            return torch.zeros((0,) + tuple(batch["left"].shape[1:3]), dtype=torch.int32), accum
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
            accum["weather_acc_sum"] = accum["weather_acc_sum"] + wacc * local_share()
            accum["n_batches"] = accum["n_batches"] + int(world().rank == 0)
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
