"""Pixel-level supervised contrast with hard-anchor sampling — port of the
JAX package's ``losses/pixel_contrast.py`` (reference ``utils/loss.py:
250-415``, Wang et al., "Exploring Cross-Image Pixel Contrast").

Fixed shapes, as in JAX: the anchors are the (B × num_classes) grid, an
anchor (b, c) is valid when class c has more than ``max_views`` pixels in
image b at feature resolution, and each anchor draws 2 pixels — one hard
(pred ≠ gt) and one easy when both kinds exist, else two of the kind that
exists — by a top-2 over uniform keys restricted to each mask. Invalid
anchors stay in the contrast under a validity mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.contrastive import pixel_contrast_loss_kernel
from ..ops.interpolate import resize_nearest
from ..parallel import gather_rows, rand_rows
from .supcon import KERNEL_MIN_N

NEG_INF = -1e30


def _hard_anchor_sampling(feats: torch.Tensor, labels: torch.Tensor,
                          preds: torch.Tensor, num_classes: int,
                          generator: Optional[torch.Generator],
                          max_views: int = 2, deterministic_select: bool = False):
    """feats (B, P, D), labels and preds (B, P) → (anchor_feats (B·C, 2, D),
    anchor_labels (B·C,), valid (B·C,)). The keys are uniform draws from
    ``generator`` (on the features' device), or, with
    ``deterministic_select``, the first raster indices of each mask (the
    reference with its ``randperm`` pinned to the identity)."""
    b, p, d = feats.shape
    cls = torch.arange(num_classes, dtype=labels.dtype, device=labels.device)
    onehot = labels[:, None, :] == cls[None, :, None]               # (B, C, P)
    right = preds[:, None, :] == cls[None, :, None]
    hard = onehot & ~right
    easy = onehot & right
    valid = onehot.sum(dim=-1) > max_views                          # loss.py:282

    if deterministic_select:
        r = -torch.arange(p, dtype=torch.float32, device=feats.device).expand(
            b, num_classes, p)
    else:
        r = rand_rows((b, num_classes, p), generator, feats.device)
    hard_idx = torch.where(hard, r, NEG_INF).topk(2, dim=-1).indices   # (B, C, 2)
    easy_idx = torch.where(easy, r, NEG_INF).topk(2, dim=-1).indices
    has_hard = hard.any(dim=-1)
    has_easy = easy.any(dim=-1)

    # loss.py:314-322 with n_view = 2: hard & easy → [hard_0, easy_0];
    # hard only → [hard_0, hard_1]; easy only → [easy_0, easy_1]
    idx0 = torch.where(has_hard, hard_idx[..., 0], easy_idx[..., 0])
    idx1 = torch.where(has_hard & has_easy, easy_idx[..., 0],
                       torch.where(has_hard, hard_idx[..., 1], easy_idx[..., 1]))
    sel = torch.stack([idx0, idx1], dim=-1).clamp(0, p - 1)           # (B, C, 2)
    batch = torch.arange(b, device=feats.device)[:, None, None]
    anchor_feats = feats[batch, sel].reshape(b * num_classes, 2, d)
    return anchor_feats, cls.repeat(b), valid.reshape(-1)


def _masked_contrastive(feats: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor, temperature: float,
                        base_temperature: float,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Reference ``_contrastive`` (``loss.py:339-389``) over (A, V, D)
    anchor views with a validity mask for the dynamically sized anchor list.
    ``use_kernel`` None routes to the kernel (``ops/contrastive.py``) when
    A·V ≥ ``KERNEL_MIN_N`` and the features are on the card."""
    a, v, _ = feats.shape
    if use_kernel is None:
        use_kernel = a * v >= KERNEL_MIN_N and feats.is_cuda
    if use_kernel:
        return pixel_contrast_loss_kernel(feats, labels, valid, temperature,
                                          base_temperature)
    n = a * v
    vv = valid.float()
    pair_valid = vv[:, None] * vv[None, :]
    same_t = ((labels[:, None] == labels[None, :]).float() * pair_valid).repeat(v, v)
    col_valid = vv.repeat(v)                                         # (N,)
    pair_valid_t = pair_valid.repeat(v, v)

    contrast = torch.cat([feats[:, i] for i in range(v)], dim=0).float()
    logits = contrast @ contrast.t() / temperature
    # max over valid columns only (invalid anchors do not exist in the reference)
    masked = torch.where(col_valid[None, :] > 0, logits, NEG_INF)
    logits = logits - masked.amax(dim=1, keepdim=True).detach()
    # row-L2 normalisation over valid columns (loss.py:366)
    logits = torch.where(col_valid[None, :] > 0, logits, 0.0)
    logits = logits / torch.linalg.vector_norm(logits, dim=1, keepdim=True).clamp_min(1e-12)

    eye = torch.eye(n, dtype=torch.float32, device=feats.device)
    pos_mask = same_t * (1.0 - eye)
    neg_mask = (1.0 - same_t) * pair_valid_t
    exp_logits = torch.exp(logits) * pair_valid_t
    neg_sum = (exp_logits * neg_mask).sum(dim=1, keepdim=True)
    # per-pair denominator of loss.py:376-381: exp(l_ij) + Σ_neg exp
    log_prob = logits - torch.log(torch.exp(logits) + neg_sum)

    pos_count = pos_mask.sum(dim=1)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) / pos_count.clamp_min(1.0)
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    row_ok = (col_valid > 0) & (pos_count > 0)
    return torch.where(row_ok, per_anchor, 0.0).sum() / row_ok.sum().clamp_min(1)


def pixel_contrast_loss(feats: torch.Tensor, labels: torch.Tensor,
                        predict_logits: torch.Tensor,
                        generator: Optional[torch.Generator], num_classes: int = 19,
                        temperature: float = 0.07, base_temperature: float = 0.07,
                        max_views: int = 2, deterministic_select: bool = False,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Reference ``PixelContrastLoss.forward`` (``loss.py:391-415``):
    feats (B, h, w, D) decoder features, labels (B, H, W) at crop
    resolution, predict_logits (B, h, w, C). Labels are nearest-downsampled
    to (h, w) and predictions argmaxed; the ignore label 255 matches no
    class, so ignored pixels drop out of every mask. With several ranks
    (``parallel/``) each draws the global batch's keys and samples its own
    rows' anchors, and the anchors of every rank are contrasted together."""
    b, h, w, dd = feats.shape
    preds = resize_nearest(predict_logits.argmax(dim=-1), (h, w))
    labels_ds = resize_nearest(labels, (h, w))
    anchor_feats, anchor_labels, valid = _hard_anchor_sampling(
        feats.reshape(b, h * w, dd).float(), labels_ds.reshape(b, -1),
        preds.reshape(b, -1).to(labels_ds.dtype), num_classes, generator,
        max_views=max_views, deterministic_select=deterministic_select)
    return _masked_contrastive(gather_rows(anchor_feats), gather_rows(anchor_labels),
                               gather_rows(valid), temperature, base_temperature,
                               use_kernel=use_kernel)
