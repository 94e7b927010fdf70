"""Boundary-aware focal and cross-entropy segmentation losses — port of the
JAX package's ``losses/focal.py`` (reference ``utils/loss.py:6-80,
208-247``).

Nothing mutates its inputs. With several ranks (``parallel/``) each mean
is over the global batch's count, its value global and its gradient the
rank's own rows'. As in JAX, ``plain_focal`` and ``no_EDT`` keep
the reference's quirk: ignore pixels are remapped to class 0 and enter the
numerator there, because those modes never multiply by the EDT weights
that are 0 at ignore pixels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import all_sum, global_value


def _gather_logpt(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """log p_t per pixel; logits (..., C), target (...,) in [0, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, target.long().unsqueeze(-1)).squeeze(-1)


def boundary_aware_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                              alphas: torch.Tensor,
                              class_weight: Optional[torch.Tensor],
                              gamma: float = 0.5, ignore_id: int = 255,
                              mode: str = "full") -> torch.Tensor:
    """−w · α · exp(γ(1 − p_t)) · log p_t summed, over #{α > 0}
    (reference ``loss.py:39-80``; γ = 0.5, ``init_trainer.py:219``).
    logits (B, H, W, C) at label resolution, target (B, H, W) with
    ``ignore_id`` holes, alphas (B, H, W) EDT weights, class_weight (C,) or
    None. ``mode``: full | plain_focal | no_class_weights | no_EDT. p_t is
    detached, as in the reference."""
    target_safe = torch.where(target == ignore_id, 0, target).long()
    logpt = _gather_logpt(logits, target_safe)
    focal = torch.exp(gamma * (1.0 - torch.exp(logpt).detach()))

    alphas = alphas.float()
    if class_weight is None and mode in ("full", "no_EDT"):
        # balanced weights disabled: drop the class weight
        mode = "plain_focal" if mode == "no_EDT" else "no_class_weights"
    if mode == "plain_focal":
        per_px = -focal * logpt
    elif mode == "no_class_weights":
        per_px = -alphas * focal * logpt
    elif mode == "no_EDT":
        per_px = -class_weight[target_safe] * focal * logpt
    else:
        per_px = -class_weight[target_safe] * alphas * focal * logpt
    # over the global batch's count: each rank's partial sum (parallel/)
    n = all_sum((alphas > 0.0).sum())
    # plain_focal too normalises by #{α > 0} (reference loss.py:73)
    return global_value(torch.where(n > 0, per_px.sum() / n.clamp_min(1), 0.0))


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       ignore_id: int = 255) -> torch.Tensor:
    """Mean CE over non-ignored pixels (``nn.CrossEntropyLoss(
    ignore_index=255)``, reference ``init_trainer.py:224``)."""
    valid = target != ignore_id
    logpt = _gather_logpt(logits, torch.where(valid, target, 0))
    return global_value(-torch.where(valid, logpt, 0.0).sum()
                        / all_sum(valid.sum()).clamp_min(1))
