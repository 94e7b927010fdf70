"""The recipe's loss, ``supcon_pixelcontrast_focal`` (DCSS, BMVC 2022):
(SupCon over the weather + pixel contrast) / B + 1.2 × the boundary-aware
focal loss. Plain float32 PyTorch on NCHW maps.

- Focal: −w[t] · α · exp(γ(1 − p_t)) · log p_t summed, over the count of
  pixels with α > 0; γ = 0.5, p_t held constant in the gradient.
- SupCon: two views, ``contrast_mode='all'``, temperature 0.07, with the
  DCSS code's row L2 normalisation of the logits after the max shift.
- Pixel contrast (Wang et al., 2021): for each (image, class) whose class
  has more than 2 pixels at feature resolution, two anchors, one hard
  (prediction wrong) and one easy when both exist, else two of the kind
  that exists, each picked as the largest of uniform keys over its mask;
  the keys are drawn from the step's generator as one (B, C, h·w) block.
  The anchors of all images are contrasted together with the same row
  normalisation."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

SEG_WEIGHT = 1.2
GAMMA = 0.5
TEMPERATURE = 0.07
IGNORE = 255


def focal(logits: torch.Tensor, target: torch.Tensor, alpha: torch.Tensor,
          class_weight: torch.Tensor) -> torch.Tensor:
    """logits (B, C, H, W), target (B, H, W), alpha (B, H, W)."""
    t = torch.where(target == IGNORE, 0, target).long()
    logp = F.log_softmax(logits.float(), dim=1).gather(1, t[:, None])[:, 0]
    weight = torch.exp(GAMMA * (1.0 - torch.exp(logp).detach()))
    per_px = -class_weight[t] * alpha * weight * logp
    n = (alpha > 0).sum()
    return per_px.sum() / n.clamp_min(1)


def supcon(proj: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """proj (B, 2, D), labels (B,)."""
    b = proj.shape[0]
    x = torch.cat([proj[:, 0], proj[:, 1]], dim=0).float()
    n = 2 * b
    logits = x @ x.t() / TEMPERATURE
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    off = 1.0 - torch.eye(n, device=x.device)
    same = (labels[:, None] == labels[None, :]).float().repeat(2, 2) * off
    logits = F.normalize(logits, dim=1)
    log_prob = logits - torch.log((torch.exp(logits) * off).sum(dim=1, keepdim=True))
    return -((same * log_prob).sum(dim=1) / same.sum(dim=1)).mean()


def nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of (B, H, W) with source floor(dst · in / out)."""
    h, w = x.shape[-2:]
    rows = torch.floor(torch.arange(size[0], device=x.device, dtype=torch.float32)
                       * (h / size[0])).long()
    cols = torch.floor(torch.arange(size[1], device=x.device, dtype=torch.float32)
                       * (w / size[1])).long()
    return x[:, rows][:, :, cols]


def pixel_contrast(feat: torch.Tensor, labels: torch.Tensor, logits: torch.Tensor,
                   generator: Optional[torch.Generator], num_classes: int,
                   max_views: int = 2) -> torch.Tensor:
    """feat (B, D, h, w), labels (B, H, W), logits (B, C, h, w)."""
    b, d, h, w = feat.shape
    p = h * w
    pred = logits.argmax(dim=1).reshape(b, p)
    lab = nearest(labels, (h, w)).reshape(b, p).long()
    f = feat.float().permute(0, 2, 3, 1).reshape(b, p, d)
    cls = torch.arange(num_classes, device=feat.device)
    member = lab[:, None, :] == cls[None, :, None]                     # (B, C, P)
    hard = member & (pred[:, None, :] != cls[None, :, None])
    easy = member & ~hard
    valid = member.sum(-1) > max_views
    keys = torch.rand((b, num_classes, p), generator=generator, device=feat.device)
    low = torch.full_like(keys, -1e30)
    hi = torch.where(hard, keys, low).topk(2, dim=-1).indices
    ei = torch.where(easy, keys, low).topk(2, dim=-1).indices
    has_h, has_e = hard.any(-1), easy.any(-1)
    first = torch.where(has_h, hi[..., 0], ei[..., 0])
    second = torch.where(has_h & has_e, ei[..., 0], torch.where(has_h, hi[..., 1], ei[..., 1]))
    pick = torch.stack([first, second], -1)                           # (B, C, 2)
    anchors = f[torch.arange(b, device=feat.device)[:, None, None], pick]   # (B, C, 2, D)
    anchors = anchors.reshape(b * num_classes, 2, d)
    a_lab = cls.repeat(b)
    a_ok = valid.reshape(-1).float()

    x = torch.cat([anchors[:, 0], anchors[:, 1]], dim=0)             # (2A, D)
    ok = a_ok.repeat(2)
    pair = ok[:, None] * ok[None, :]
    same = (a_lab.repeat(2)[:, None] == a_lab.repeat(2)[None, :]).float() * pair
    logits_x = x @ x.t() / TEMPERATURE
    shift = torch.where(ok[None, :] > 0, logits_x, -1e30).amax(dim=1, keepdim=True).detach()
    logits_x = torch.where(ok[None, :] > 0, logits_x - shift, 0.0)
    logits_x = logits_x / logits_x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    eye = torch.eye(x.shape[0], device=x.device)
    pos = same * (1.0 - eye)
    neg = (1.0 - same) * pair
    neg_sum = (torch.exp(logits_x) * pair * neg).sum(dim=1, keepdim=True)
    log_prob = logits_x - torch.log(torch.exp(logits_x) + neg_sum)
    count = pos.sum(dim=1)
    per_anchor = -(pos * log_prob).sum(dim=1) / count.clamp_min(1.0)
    rows = (ok > 0) & (count > 0)
    return torch.where(rows, per_anchor, 0.0).sum() / rows.sum().clamp_min(1)


def total(out: Dict[str, torch.Tensor], label: torch.Tensor, alpha: torch.Tensor,
          weather: torch.Tensor, class_weight: torch.Tensor,
          generator: Optional[torch.Generator], num_classes: int,
          parts: Optional[dict] = None) -> torch.Tensor:
    """The loss; ``parts``, when given, receives its three terms."""
    b = label.shape[0]
    sc = supcon(out["supcon_proj"], weather)
    pc = pixel_contrast(out["fine_feat0"], label, out["seg_beforeup"], generator, num_classes)
    seg = focal(out["seg"], label, alpha, class_weight)
    if parts is not None:
        parts.update(seg_loss=float(seg), supcon_loss=float(sc), pixelcontrast_loss=float(pc))
    return (sc + pc) / b + SEG_WEIGHT * seg
