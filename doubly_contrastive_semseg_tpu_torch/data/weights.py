"""Class-balanced weight computation — a copy of the JAX package's
``data/weights.py``.

Reference behavior split across two places:
- raw pixel frequencies cached to
  ``<data_root>/<dataset>_classes_weights_<C>_new_raw.npy``
  (``utils/calculate_weights.py:31-58``);
- refined at trainer init to ``w = 1 / log(1 + ε + freq)``
  (``utils/init_trainer.py:205-213``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np


def compute_class_frequencies(dataset, num_classes: int,
                              max_samples: Optional[int] = None) -> np.ndarray:
    """Pixel-frequency ratio per class over the dataset's labels
    (reference ``calculate_weigths_labels_new``)."""
    z = np.zeros((num_classes,), np.float64)
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        sample = dataset[i]
        # under TwoCropTransform (any supcon criterion) an item is a list of
        # two view dicts; the reference iterates the collated train loader,
        # whose custom_collate concatenates both crops — count both labels
        views = sample if isinstance(sample, (list, tuple)) else [sample]
        for view in views:
            y = np.asarray(view["label"])
            mask = (y >= 0) & (y < num_classes)
            z += np.bincount(y[mask].astype(np.int64), minlength=num_classes)
    total = z.sum()
    return (z / total) if total > 0 else z


def balanced_class_weights(freq: np.ndarray, epsilon: float) -> np.ndarray:
    """w = 1 / log(1 + ε + freq) (reference ``init_trainer.py:205-213``)."""
    return (1.0 / np.log(1.0 + epsilon + freq)).astype(np.float32)


def load_or_compute_class_weights(cfg, dataset) -> np.ndarray:
    """Cache-aware weight loading mirroring ``init_trainer.py:185-213``."""
    data_root = cfg.data_root
    if cfg.dataset == "acdc_city":
        data_root = data_root.replace("acdc_city", "acdc")
    cache = os.path.join(
        data_root, f"{cfg.dataset}_classes_weights_{cfg.num_classes}_new_raw.npy")
    if os.path.isfile(cache):
        freq = np.load(cache)
    else:
        freq = compute_class_frequencies(dataset, cfg.num_classes)
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, freq)
        except OSError:
            logging.warning("could not cache class weights at %s", cache)
    weights = balanced_class_weights(freq, cfg.epsilon)
    logging.info("class pixel ratio: %s", freq)
    logging.info("refined class weights: %s (max/min %.3f)", weights,
                 weights.max() / max(weights.min(), 1e-12))
    return weights
