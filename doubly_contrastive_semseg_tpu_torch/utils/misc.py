"""Small parity utilities — port of the JAX package's ``utils/misc.py``
(reference ``utils/utils.py:6-129``), in numpy as there."""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np


class Denormalize:
    """Invert a mean/std normalization for visualization
    (reference ``utils/utils.py`` Denormalize)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        # img (..., C) or (C, H, W)
        if img.ndim == 3 and img.shape[0] == len(self.mean):
            return img * self.std[:, None, None] + self.mean[:, None, None]
        return img * self.std + self.mean


def accuracy(logits: np.ndarray, target: np.ndarray,
             topk: Tuple[int, ...] = (1,)) -> List[float]:
    """Top-k accuracies in percent (reference ``utils/utils.py`` accuracy)."""
    target = np.asarray(target).reshape(-1)
    order = np.argsort(-np.asarray(logits), axis=-1)
    out = []
    for k in topk:
        hit = (order[:, :k] == target[:, None]).any(axis=1)
        out.append(float(hit.mean()) * 100.0)
    return out


def read_text_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


# param-group name filters (reference utils/utils.py filter_* — used by the
# SGD policy's 4-group layout; the optimizer labels by module path instead,
# see utils/params.py, but the name-based filters are kept for API parity)
def filter_specific_params(kv) -> bool:
    return any(s in kv[0] for s in ("offset_conv", "deform"))


def filter_semantic_params(kv) -> bool:
    return "segmentation" in kv[0]


def filter_feature_extractor_params(kv) -> bool:
    return "feature_extractor" in kv[0]


def filter_base_params(kv) -> bool:
    return not (filter_specific_params(kv) or filter_semantic_params(kv)
                or filter_feature_extractor_params(kv))
