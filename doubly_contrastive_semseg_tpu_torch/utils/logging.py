"""Logger and RNG seeding — port of the JAX package's ``utils/logging.py``
(reference ``utils/logger.py:13-49``, ``main.py:23-33``)."""

from __future__ import annotations

import logging
import os
import random
import sys
from datetime import datetime
from typing import Optional

import numpy as np
import torch


def setup_logger(save_dir: Optional[str] = None, name_prefix: str = "run") -> logging.Logger:
    """The root logger to stdout and a per-run log file (reference
    ``utils/logger.py``)."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%m/%d %H:%M:%S")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(save_dir, f"{name_prefix}_{ts}_log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seeds python's, numpy's and torch's global generators
    (detectron2-style, reference ``logger.py:33-49``). The port's own draws
    come from explicitly seeded ``torch.Generator``s."""
    if seed is None:
        seed = (os.getpid()
                + int(datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big"))
    np.random.seed(seed % (2 ** 31))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed
