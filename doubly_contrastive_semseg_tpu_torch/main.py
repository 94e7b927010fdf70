"""Training CLI of the port — JAX ``main.py:15-63`` at world size 1:
seed, build the ``Trainer``, then the epoch loop train → validate from
``cur_epochs`` to ``--epochs``; ``--test_only`` runs one validation pass;
``--tsne`` renders the t-SNE of the model's features
(``tools/tsne.py::Viz``) and trains nothing.

    python -m doubly_contrastive_semseg_tpu_torch.main --dataset synthetic \\
        --train_semantic --criterion supcon_pixelcontrast_focal --epochs 1 \\
        --batch_size 2 --debug --device cpu

The stereo datasets (``sceneflow``, ``kitti_2015``, ``kitti_mix``) and the
synthetic disparity route (``--dataset synthetic --transfer_disparity
--criterion none`` without ``--train_semantic``; ``config.py::
is_stereo_run``) go to the ``StereoTrainer`` (JAX ``main.py:32-47``):
train → validate each epoch, or under ``--test_only`` one validation that
writes no checkpoint.

    python -m doubly_contrastive_semseg_tpu_torch.main --dataset synthetic \
        --transfer_disparity --criterion none --refinement_type stereonet \
        --debug --device cpu

Runs on the card unless ``--device cpu`` is given; with ``cuda`` and no
card it raises. ``--num_devices`` above 1 raises ``NotImplementedError``
naming its ``ROADMAP.md`` item (``config.py::check_ported``, called by both
trainers).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional, Sequence, Union

import torch

from .config import is_stereo_run, parse_args
from .tools.tsne import Viz
from .train import StereoTrainer, Trainer
from .utils import seed_all_rng


def main(argv: Optional[Sequence[str]] = None) -> Union[Trainer, StereoTrainer, Viz]:
    """Runs the CLI on ``argv`` (``sys.argv[1:]`` when None) and returns the
    trainer (under ``--tsne`` the ``Viz``)."""
    cfg = parse_args(argv)
    seed_all_rng(cfg.random_seed)

    if cfg.tsne:
        viz = Viz(cfg, device=cfg.device)
        viz.run()
        return viz

    if cfg.test_only and cfg.resume is None and not cfg.pretrained:
        raise RuntimeError("--test_only requires --resume or --pretrained")

    if cfg.device == "cuda":
        torch.backends.cudnn.benchmark = True
    if is_stereo_run(cfg):
        stereo = StereoTrainer(cfg, device=cfg.device)
        if cfg.test_only:
            stereo.validate(save_ckpt=False)
            return stereo
        for epoch in range(stereo.cur_epochs, cfg.epochs):
            stereo.cur_epochs = epoch
            stereo.train()
            stereo.validate()
        return stereo

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
