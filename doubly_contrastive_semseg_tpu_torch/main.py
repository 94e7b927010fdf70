"""Training CLI of the port — JAX ``main.py:15-63``:
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
card it raises. ``--num_devices`` N above 1 (JAX's mesh over N devices)
starts N ranks with ``torch.multiprocessing`` (``parallel/launch.py``), rank
r on ``cuda:r`` with NCCL, or on the CPU with gloo; each runs the same
``run`` on its share of every batch (``parallel/``); ``--tsne`` runs in
one process. Fewer visible GPUs than N raise ``ValueError``. SIGTERM/SIGINT to this process stop every rank
after the same finished step, rank 0 writing the rescue checkpoint, and
this process exits as one process would (143 on SIGTERM).

    python -m doubly_contrastive_semseg_tpu_torch.main --dataset synthetic \
        --train_semantic --epochs 1 --batch_size 4 --num_devices 2 --device cpu
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional, Sequence, Union

import torch

from .config import is_stereo_run, parse_args
from .parallel import active, check_devices, leave, make_mesh, spawn_ranks, world
from .tools.tsne import Viz
from .train import StereoTrainer, Trainer
from .utils import seed_all_rng


def main(argv: Optional[Sequence[str]] = None) -> Union[Trainer, StereoTrainer, Viz, None]:
    """Runs the CLI on ``argv`` (``sys.argv[1:]`` when None) and returns the
    trainer (under ``--tsne`` the ``Viz``); with ``--num_devices`` above 1
    it waits for the ranks and returns None."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_args(argv)
    if cfg.test_only and cfg.resume is None and not cfg.pretrained and not cfg.tsne:
        raise RuntimeError("--test_only requires --resume or --pretrained")
    if (cfg.num_devices or 1) > 1 and not cfg.tsne:
        check_devices(cfg)
        spawn_ranks(run_rank, cfg.num_devices, (argv,))
        return None
    return run(cfg)


def run_rank(rank: int, n: int, init_method: str, stop, argv: Sequence[str]) -> None:
    """Rank ``rank`` of ``n``: joins the process group (``cuda:rank`` with
    NCCL, or gloo with ``--device cpu``) and runs the CLI's ``run``."""
    cfg = parse_args(argv)
    device = torch.device("cuda", rank) if cfg.device == "cuda" else torch.device("cpu")
    make_mesh(rank, n, init_method, device, stop=stop)
    try:
        run(cfg)
    finally:
        leave()


def run(cfg) -> Union[Trainer, StereoTrainer, Viz]:
    """Seeds, builds the trainer on this rank's device and runs the epochs
    (or one validation under ``--test_only``, the t-SNE under ``--tsne``)."""
    seed_all_rng(cfg.random_seed)

    if cfg.tsne:
        viz = Viz(cfg, device=cfg.device)
        viz.run()
        return viz

    device = world().device if active() else cfg.device
    if cfg.device == "cuda":
        torch.backends.cudnn.benchmark = True
    if is_stereo_run(cfg):
        stereo = StereoTrainer(cfg, device=device)
        if cfg.test_only:
            stereo.validate(save_ckpt=False)
            return stereo
        for epoch in range(stereo.cur_epochs, cfg.epochs):
            stereo.cur_epochs = epoch
            stereo.train()
            stereo.validate()
            stereo.check_stop()
        return stereo

    trainer = Trainer(cfg, device=device)

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
        trainer.check_stop()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
