"""Image-level supervised-contrastive / SimCLR loss — port of the JAX
package's ``losses/supcon.py`` (reference ``utils/loss.py:84-205``).

Keeps the reference's two deviations from the published SupCon: the row-L2
normalisation of the logits matrix after the max shift (``loss.py:194``)
and ``contrast_mode='all'`` for SupCon and SimCLR alike (``loss.py:111``).
The projection head lives in the model (``models/weathernet.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.contrastive import supcon_loss_kernel
from ..parallel import gather_rows

# From this many rows (2B) on the card, the loss goes through the contrastive
# kernel (ops/contrastive.py): the JAX package's PALLAS_MIN_N
# (losses/supcon.py:31), its measured training crossover, kept as it is.
KERNEL_MIN_N = 8_192


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                temperature: float = 0.07, base_temperature: float = 0.07,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """SupCon (``labels`` (B,) given) or SimCLR (``labels`` None) over
    (B, 2, D) projected two-view embeddings; the mean over all 2B anchors.
    ``use_kernel`` None routes to the kernel when 2B ≥ ``KERNEL_MIN_N`` and
    the features are on the card; True/False forces the route. With several
    ranks the features and labels are gathered first (``parallel/``): the
    loss is the global batch's, the route chosen by its 2B."""
    features = gather_rows(features)
    labels = None if labels is None else gather_rows(labels.reshape(-1))
    if use_kernel is None:
        use_kernel = 2 * features.shape[0] >= KERNEL_MIN_N and features.is_cuda
    if use_kernel:
        return supcon_loss_kernel(features, labels, temperature, base_temperature)
    features = features.float()
    bsz = features.shape[0]
    if labels is None:
        mask = torch.eye(bsz, dtype=torch.float32, device=features.device)
    else:
        labels = labels.reshape(-1)
        mask = (labels[:, None] == labels[None, :]).float()

    contrast = torch.cat([features[:, 0], features[:, 1]], dim=0)  # (2B, D)
    n = 2 * bsz
    logits = contrast @ contrast.t() / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()

    logits_mask = 1.0 - torch.eye(n, dtype=torch.float32, device=features.device)
    mask = mask.repeat(2, 2) * logits_mask
    logits = F.normalize(logits, dim=1)  # reference loss.py:194

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1)
    return (-(temperature / base_temperature) * mean_log_prob_pos).mean()
