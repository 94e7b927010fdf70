"""The numbers that decide ``correct``, each compared with its limit.

Training: the largest relative gap of a step's loss over the first three
steps (``loss_gap``); the worst leaf's gap between the program's and the
reference's norms of the first gradient as Adam takes it (``grad_gap``),
and the median leaf's (``grad_median_gap``); the worst leaf's gap of norms
of the parameters' change over the three steps (``change_gap``). Each
leaf's gap is over the larger of its reference norm and the median leaf's.
A leaf whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone under Adam and is left out of ``change_gap``. A
cell's limits file names the numbers it compares.

Serving: the widest gap by which the reference's logit of a served label
lies below the reference's best logit at that pixel, over the sampled
frames, in units of the frame's logit spread (``label_gap``), and the gap
that a ten-thousandth of a frame's pixels exceed (``label_tail_gap``), the
worst frame's."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

QUIET_GRADIENT = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's; a leaf the program does not hold reads 1."""
    names = [n for n in ref if keep(n)]
    if not names:
        return []
    median = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) if n in prog else 1.0
            for n in names]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}. A leaf the reference trains that the program
    does not hold counts as a gap of 1."""
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    median_g = statistics.median(ref["grad"].values())
    moving = {n for n, g in ref["grad"].items() if g >= QUIET_GRADIENT * median_g}
    grads = _leaf_gaps(prog["grad"], ref["grad"], lambda n: True)
    changes = _leaf_gaps(prog["change"], ref["change"], lambda n: n in moving)
    return {"loss_gap": loss,
            "grad_gap": max(grads, default=None),
            "grad_median_gap": statistics.median(grads) if grads else None,
            "change_gap": max(changes, default=None)}


def look(prog: dict, ref: dict) -> dict:
    """What stands behind the training numbers, for the calibration: each
    step's loss and its terms on both sides, and the median and 90th
    percentile of the leaves' gaps."""
    def leaf_gaps(key):
        names = [n for n in ref[key] if n in prog[key]]
        median = statistics.median(ref[key][n] for n in names)
        gaps = sorted(abs(prog[key][n] - ref[key][n]) / max(ref[key][n], median, 1e-30)
                      for n in names)
        worst = max(names, key=lambda n: abs(prog[key][n] - ref[key][n])
                    / max(ref[key][n], median, 1e-30))
        return {"median": gaps[len(gaps) // 2], "p90": gaps[int(0.9 * (len(gaps) - 1))],
                "worst_leaf": worst}
    return {"loss": [prog["loss"], ref["loss"]], "parts": [prog.get("parts"), ref.get("parts")],
            "grad": leaf_gaps("grad"), "change": leaf_gaps("change")}


TAIL = 1e-4       # the share of a frame's pixels above ``label_tail_gap``


def label_gaps(logits: torch.Tensor, served: torch.Tensor) -> Dict[str, float]:
    """logits (C, h, w) float32, the reference's at feature resolution;
    served (H, W) labels at 4×. Each pixel's gap is how far the served
    label's logit of the ×4 bilinear logits lies below the best, over their
    standard deviation: ``label_gap`` the widest, ``label_tail_gap`` the
    smallest of the widest ``TAIL`` share of the frame's pixels."""
    up = F.interpolate(logits[None], scale_factor=4, mode="bilinear", align_corners=False)[0]
    best = up.amax(dim=0)
    got = up.gather(0, served.long().clamp(0, up.shape[0] - 1)[None])[0]
    out_of_range = (served.long() < 0) | (served.long() >= up.shape[0])
    gap = torch.where(out_of_range, torch.inf, best - got).flatten() / up.std().clamp_min(1e-30)
    k = max(1, int(TAIL * gap.numel()))
    return {"label_gap": float(gap.max()), "label_tail_gap": float(gap.topk(k).values[-1])}


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> bool:
    """Every number is present and within its limit."""
    return all(numbers.get(k) is not None and numbers[k] <= lim for k, lim in limits.items())


def checks(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
