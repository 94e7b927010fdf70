"""Training CLI of the port — JAX ``main.py:15-63`` at world size 1:
seed, build the ``Trainer``, then the epoch loop train → validate from
``cur_epochs`` to ``--epochs``; ``--test_only`` runs one validation pass.

    python -m doubly_contrastive_semseg_tpu_torch.main --dataset synthetic \\
        --train_semantic --criterion supcon_pixelcontrast_focal --epochs 1 \\
        --batch_size 2 --debug --device cpu

Runs on the card unless ``--device cpu`` is given; with ``cuda`` and no
card it raises. The stereo datasets and ``--tsne`` raise
``NotImplementedError`` naming their ``ROADMAP.md`` items
(``config.py::check_ported``, called by the ``Trainer``).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional, Sequence

import torch

from .config import parse_args
from .train import Trainer
from .utils import seed_all_rng


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Runs the CLI on ``argv`` (``sys.argv[1:]`` when None) and returns the
    trainer."""
    cfg = parse_args(argv)
    seed_all_rng(cfg.random_seed)

    if cfg.test_only and cfg.resume is None and not cfg.pretrained:
        raise RuntimeError("--test_only requires --resume or --pretrained")

    if cfg.device == "cuda":
        torch.backends.cudnn.benchmark = True
    trainer = Trainer(cfg, device=cfg.device)

    if cfg.test_only:
        trainer.test()
        return trainer

    for epoch in range(trainer.cur_epochs, cfg.epochs):
        t0 = time.time()
        trainer.cur_epochs = epoch
        trainer.train()
        trainer.validate()
        trainer.epoch_seconds.append(time.time() - t0)
        logging.info("epoch %d took %.1f s", epoch, time.time() - t0)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
