"""Criterion dispatch — port of the JAX package's ``losses/combine.py``, the
loss combinations of the reference trainer (``trainer.py:116-203``):

  supcon_focal                      total = supcon/bsz + 1.2·seg
  supcon_simclr_focal               total = simclr/bsz + 1.2·seg
  pixelcontrast_focal               total = pixel/bsz + 1.2·seg
  supcon_pixelcontrast_focal        total = (supcon+pixel)/bsz + 1.2·seg
  supcon_simclr_pixelcontrast_focal total = (simclr+pixel)/bsz + 1.2·seg
  crossentropy                      total = ce
  supcon_crossentropy               total = ce + supcon
  supcon_simclr_cross_entropy       total = ce + simclr  (the reference adds
                                    the zero supcon loss here; fixed, as in JAX)
  plain_focal / none / others       total = seg

The weather classifier's CE is for monitoring and stays out of the total
(reference ``trainer.py:205-206``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..parallel import global_mean, global_rows
from .focal import boundary_aware_focal_loss, cross_entropy_loss
from .pixel_contrast import pixel_contrast_loss
from .supcon import supcon_loss

SEG_WEIGHT = 1.2  # reference trainer.py:123


def weather_classifier_metrics(weather_logits: torch.Tensor, gt_weather: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE and top-1 accuracy (%) of the weather head (reference
    ``trainer.py:109-114``), over the global batch with several ranks."""
    gt = gt_weather.reshape(-1).long()
    logp = torch.log_softmax(weather_logits.float(), dim=-1)
    ce = -global_mean(logp.gather(-1, gt[:, None]))
    acc = global_mean((weather_logits.argmax(dim=-1) == gt).float()) * 100.0
    return ce, acc


def _seg_loss(cfg, outputs, batch, class_weight) -> torch.Tensor:
    mode = "full"
    if cfg.criterion == "plain_focal":
        mode = "plain_focal"
    elif cfg.no_class_weights:
        mode = "no_class_weights"
    elif cfg.no_EDT:
        mode = "no_EDT"
    return boundary_aware_focal_loss(
        outputs["seg"], batch["label"], batch["label_distance_weight"],
        class_weight, gamma=0.5, ignore_id=cfg.ignore_index, mode=mode)


def compute_total_loss(cfg, outputs: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor],
                       class_weight: Optional[torch.Tensor],
                       generator: Optional[torch.Generator],
                       use_kernel: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, components) for ``cfg.criterion``. ``generator`` draws
    the pixel-contrast anchors (unused under ``cfg.reference_rng``);
    ``use_kernel`` forces the contrastive losses' route (None: by size)."""
    crit = cfg.criterion
    zero = torch.zeros((), dtype=torch.float32, device=outputs["seg"].device)
    comps = {"seg_loss": zero, "supcon_loss": zero, "simclr_loss": zero,
             "pixelcontrast_loss": zero, "ce_loss": zero}
    bsz = global_rows(batch["label"].shape[0])

    def supcon(labels):
        return supcon_loss(outputs["supcon_proj"], labels, use_kernel=use_kernel)

    def pixel():
        return pixel_contrast_loss(
            outputs["fine_feat0"], batch["label"], outputs["seg_beforeup"], generator,
            num_classes=cfg.num_classes, deterministic_select=cfg.reference_rng,
            use_kernel=use_kernel)

    def seg():
        return _seg_loss(cfg, outputs, batch, class_weight)

    def ce():
        return cross_entropy_loss(outputs["seg"], batch["label"],
                                  ignore_id=cfg.ignore_index)

    if crit == "supcon_focal":
        comps["supcon_loss"], comps["seg_loss"] = supcon(batch["weather"]), seg()
        total = comps["supcon_loss"] / bsz + SEG_WEIGHT * comps["seg_loss"]
    elif crit == "supcon_simclr_focal":
        comps["simclr_loss"], comps["seg_loss"] = supcon(None), seg()
        total = comps["simclr_loss"] / bsz + SEG_WEIGHT * comps["seg_loss"]
    elif crit == "pixelcontrast_focal":
        comps["pixelcontrast_loss"], comps["seg_loss"] = pixel(), seg()
        total = comps["pixelcontrast_loss"] / bsz + SEG_WEIGHT * comps["seg_loss"]
    elif crit == "supcon_pixelcontrast_focal":  # the doubly-contrastive flagship
        comps["supcon_loss"] = supcon(batch["weather"])
        comps["pixelcontrast_loss"] = pixel()
        comps["seg_loss"] = seg()
        total = ((comps["supcon_loss"] + comps["pixelcontrast_loss"]) / bsz
                 + SEG_WEIGHT * comps["seg_loss"])
    elif crit == "supcon_simclr_pixelcontrast_focal":
        comps["simclr_loss"] = supcon(None)
        comps["pixelcontrast_loss"] = pixel()
        comps["seg_loss"] = seg()
        total = ((comps["simclr_loss"] + comps["pixelcontrast_loss"]) / bsz
                 + SEG_WEIGHT * comps["seg_loss"])
    elif crit == "crossentropy":
        comps["ce_loss"] = ce()
        total = comps["ce_loss"]
    elif crit == "supcon_crossentropy":
        comps["supcon_loss"], comps["ce_loss"] = supcon(batch["weather"]), ce()
        total = comps["ce_loss"] + comps["supcon_loss"]
    elif crit == "supcon_simclr_cross_entropy":
        comps["simclr_loss"], comps["ce_loss"] = supcon(None), ce()
        total = comps["ce_loss"] + comps["simclr_loss"]
    else:
        # plain_focal / 'none' / the rest: segmentation loss only
        comps["seg_loss"] = seg()
        total = comps["seg_loss"]
    comps["total_loss"] = total
    return total, comps
