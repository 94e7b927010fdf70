"""StereoTrainer: disparity (and optionally semantic) training of
``StereoDCSS`` — port of the JAX package's ``train/trainer_stereo.py``.

``main`` sends ``--dataset sceneflow|kitti_2015|kitti_mix``, and the
synthetic disparity route (``--dataset synthetic --transfer_disparity
--criterion none`` without ``--train_semantic``), here. Init order as in
JAX: saver → datasets and loaders → model → one training batch drawn →
optimizer → checkpoint restore → step → summary writer. The loops run
eagerly on ``device`` (the card unless the caller asks for the CPU).

Data (``_stereo_dataset``): the synthetic pairs of ``SyntheticStereoDataset``
(8 frames with ``--debug``, else 32, at 64×96, disparities below 16;
validation 4 frames of seed 1), or the file lists through ``Cityscapes`` with
the disparity loaded: train ``RandomColor`` → ``StereoRandomCrop(label_pad=
255)`` → ``ToArrays``, all on one ``ThreadSafeRng`` of ``random_seed``;
validation a centre pad-or-crop. The crop and pad shapes are
``_STEREO_TRAIN_HW`` / ``_STEREO_VAL_HW`` while ``--img_*`` / ``--val_img_*``
keep their defaults.

Model: ``max_disp`` 32 on synthetic data and 192 elsewhere; the backbone
``cfg.model`` when it is resnet18, resnet34 or efficientnetb0, else
resnet18. Optimizer: Adam (0.9, 0.99) over every parameter in one group on
``cfg.lr``'s schedule (``build_stereo_optimizer``). Validation: the eval
forward's disparity (the trunk's stems through K2 on the card with
``fuse_stem``), the mean over batches of each batch's EPE, D1 and >1 px
share; ``score_best_checkpoint`` when the EPE improves, ``latest_checkpoint``
always, neither under ``--test_only``.

JAX draws one training batch at construction to initialise its model,
which consumes the train transforms' draws of that batch's samples; the
port draws the same samples (the first batch of epoch 0) there, so that the
epochs see JAX's crops and colours. JAX's threaded loader may read ahead a
few samples more; how many depends on its threads' timing, so the port
reads exactly the first batch.

With ``--num_devices`` N (``parallel/``) every rank reads the same batches
and keeps its share, the step is the global batch's, and each val batch's
EPE, D1 and >1 px share are the global batch's (the ranks' sums, all-reduced
once at the end of the pass). Rank 0 alone writes the run directory, logs,
summaries and checkpoints. A signal stops every rank after the same
finished step, without a checkpoint, as one process stops.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..data.cityscapes import Cityscapes
from ..data.loader import DataLoader, to_device
from ..data.stereo_transforms import RandomColor, StereoRandomCrop
from ..data.synthetic import SyntheticStereoDataset
from ..data.transforms import Compose, ThreadSafeRng, ToArrays
from ..metrics.disparity import disparity_sums, metrics_from_sums
from ..models.stereo import build_stereo_model
from ..utils import count_parameters
from .checkpoints import CheckpointManager
from .optimizer import build_stereo_optimizer
from .state import TrainState
from .ranks import SignalStop, make_saver, make_writer, setup_run_logger
from .steps import ingest_batch, make_stereo_train_step

# the (train crop, val pad-or-crop) shapes of the stereo lists while the
# --img_* flags keep their defaults: KITTI's frames are about 375x1242 and
# of mixed sizes, which the semantic defaults would pad on one axis and crop
# on the other (all multiples of 32, for the pyramid)
_STEREO_TRAIN_HW = {"kitti_2015": (288, 1152), "kitti_mix": (288, 1152),
                    "sceneflow": (288, 576)}
_STEREO_VAL_HW = {"kitti_2015": (384, 1248), "kitti_mix": (384, 1248),
                  "sceneflow": (576, 960)}

STEREO_BACKBONES = ("resnet18", "resnet34", "efficientnetb0")


def _stereo_dataset(cfg, mode: str):
    """The train (``mode="train"``) or val dataset of a stereo run."""
    if cfg.dataset == "synthetic":
        size = 8 if cfg.debug else 32
        return SyntheticStereoDataset(size=size if mode == "train" else 4, image_hw=(64, 96),
                                      max_disp=16, seed=0 if mode == "train" else 1)
    dflt = Config()
    if mode == "train":
        h, w = cfg.img_height, cfg.img_width
        if (h, w) == (dflt.img_height, dflt.img_width) and cfg.dataset in _STEREO_TRAIN_HW:
            h, w = _STEREO_TRAIN_HW[cfg.dataset]
        rng = ThreadSafeRng(np.random.default_rng(cfg.random_seed))
        t = Compose([RandomColor(rng=rng), StereoRandomCrop(h, w, label_pad=255, rng=rng),
                     ToArrays()])
    else:
        h, w = cfg.val_img_height, cfg.val_img_width
        if (h, w) == (dflt.val_img_height, dflt.val_img_width) and \
                cfg.dataset in _STEREO_VAL_HW:
            h, w = _STEREO_VAL_HW[cfg.dataset]
        t = Compose([StereoRandomCrop(h, w, validate=True, label_pad=255), ToArrays()])
    logging.info("stereo %s pipeline: %dx%d pad-or-crop", mode, h, w)
    return Cityscapes(root=cfg.data_root, dataset_name=cfg.dataset, mode=mode, transform=t,
                      opts=cfg, filelist_root=cfg.filelist_root, load_disp=True)


class StereoTrainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoTrainer: CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        self.cfg = cfg
        self.saver = make_saver(cfg)
        self.main_rank = self.saver.write
        self.saver.save_experiment_config()
        setup_run_logger(self.saver, f"stereo_{cfg.dataset}")

        self.train_dst = _stereo_dataset(cfg, "train")
        self.val_dst = _stereo_dataset(cfg, "val")
        self.train_loader = DataLoader(self.train_dst, cfg.batch_size, shuffle=True,
                                       num_workers=cfg.num_workers, drop_last=True,
                                       seed=cfg.random_seed)
        self.val_loader = DataLoader(self.val_dst, cfg.val_batch_size,
                                     num_workers=cfg.num_workers)

        self.model = build_stereo_model(
            device=self.device, seed=cfg.random_seed,
            max_disp=32 if cfg.dataset == "synthetic" else 192,
            num_classes=cfg.num_classes, train_semantic=cfg.train_semantic,
            backbone=cfg.model if cfg.model in STEREO_BACKBONES else "resnet18",
            aggregation_type=cfg.aggregation_type, refinement_type=cfg.refinement_type,
            deform_impl=cfg.deform_impl, fuse_stem=cfg.fuse_stem, dtype=cfg.compute_dtype)
        self._draw_first_batch()

        steps_per_epoch = max(1, len(self.train_loader))
        self.optimizer = build_stereo_optimizer(self.model, cfg, steps_per_epoch)
        self.state = TrainState(self.model, self.optimizer)
        logging.info("stereo model: %.2fM params on %s",
                     count_parameters(self.model) / 1e6, self.device)

        self.ckpt = CheckpointManager(self.saver.checkpoint_dir) if self.main_rank else None
        self.cur_epochs = 0
        self.num_iter = 0
        self.best_epe = float("inf")
        if cfg.resume is not None:
            # the recipes chain checkpoints: sceneflow pretraining, then KITTI
            if not os.path.isfile(cfg.resume):
                raise RuntimeError(f"=> no checkpoint found at '{cfg.resume}'")
            self.state, meta = CheckpointManager.restore(
                cfg.resume, self.state, continue_training=cfg.continue_training)
            if cfg.continue_training:
                self.cur_epochs = int(meta.get("epoch", -1)) + 1
                self.num_iter = int(meta.get("num_iter", 0)) + 1
                saved_best = float(meta.get("best_score", 0.0))
                # 0.0 records no best (a lower EPE is better; 0.0 is out of reach)
                self.best_epe = saved_best if saved_best > 0.0 else float("inf")
                logging.info("Training state restored from %s (epoch %d)",
                             cfg.resume, self.cur_epochs)
            else:
                logging.info("Weights restored from %s", cfg.resume)
        parallel.broadcast_module(self.model)
        self._train_step = make_stereo_train_step(self.model, cfg, self.optimizer)
        self.writer = make_writer(self.saver, not cfg.no_build_summary)
        self._signal_stop = SignalStop() if parallel.active() else None

        # per train step (epoch, loader wait s, host s of the step); per
        # epoch the mean of each loss component
        self.step_times: List = []
        self.epoch_losses: List = []

    def _draw_first_batch(self) -> None:
        """The samples of epoch 0's first batch, read and dropped: the train
        transforms' draws that JAX's construction-time batch consumes."""
        batches = self.train_loader._batch_indices()
        if not batches:
            raise ValueError(f"the train set has {len(self.train_dst)} samples, fewer than "
                             f"the batch size {self.cfg.batch_size}")
        for i in batches[0]:
            self.train_dst[int(i)]

    def train(self) -> None:
        cfg = self.cfg
        self.train_loader.set_epoch(self.cur_epochs)
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        last = time.time()
        batches = iter(self.train_loader)
        try:
            for i, batch in enumerate(batches):
                wait = time.time() - last
                self.num_iter += 1
                t0 = time.time()
                metrics = self._train_step(
                    self.state, to_device(parallel.shard_batch(batch), self.device))
                for k, v in metrics.items():   # summed on the device
                    sums[k] = sums[k] + v if k in sums else v
                n += 1
                if self.num_iter % cfg.print_freq == 0:
                    logging.info("Epoch [%d][%d] disp_loss %.4f total %.4f", self.cur_epochs,
                                 i, float(metrics["disp_loss"]), float(metrics["total_loss"]))
                    self.writer.add_scalar("train/disp_loss", float(metrics["disp_loss"]),
                                           self.num_iter)
                last = time.time()
                self.step_times.append((self.cur_epochs, wait, last - t0))
                self.check_stop()
        finally:
            batches.close()   # stops the loader's threads on any exit
        self.epoch_losses.append((self.cur_epochs,
                                  {k: float(v) / max(n, 1) for k, v in sums.items()}))

    def check_stop(self) -> None:
        """With several ranks: once a signal reached any rank or the
        launcher, every rank stops here, after the same finished step
        (``SystemExit(128 + signum)``)."""
        if self._signal_stop is not None:
            signum = self._signal_stop.agreed()
            if signum:
                raise SystemExit(128 + signum)

    @torch.no_grad()
    def validate(self, save_ckpt: bool = True) -> Dict[str, float]:
        """One pass over the val set: the mean over batches of each batch's
        EPE, D1 and >1 px share; ``save_ckpt=False`` (``--test_only``)
        writes no checkpoint."""
        self.model.eval()
        sums = []
        for batch in self.val_loader:
            db = to_device(parallel.shard_batch({k: batch[k] for k in ("left", "right", "disp")}),
                           self.device)
            if len(db["disp"]) == 0:   # a rank without a sample of this batch
                sums.append(torch.zeros(4, device=self.device))
                continue
            b = ingest_batch(db)
            disp = self.model.disparity(b["left"], b["right"])[0]["disp"]
            sums.append(disparity_sums(disp, db["disp"], 1.0))
        per_batch = metrics_from_sums(parallel.all_sum(torch.stack(sums))).cpu().numpy()
        res = {k: float(np.mean([float(m) for m in per_batch[:, i]]))
               for i, k in enumerate(("epe", "d1", "thres1"))}
        if not self.main_rank:
            parallel.barrier()
            return res
        logging.info("val: EPE %.4f  D1 %.4f  >1px %.4f", res["epe"], res["d1"], res["thres1"])
        self.writer.add_scalar("val/epe", res["epe"], self.cur_epochs)
        self.writer.add_scalar("val/d1", res["d1"], self.cur_epochs)
        if save_ckpt:
            if res["epe"] < self.best_epe:
                self.best_epe = res["epe"]
                self.ckpt.save("score_best_checkpoint", self.state, self.cur_epochs, score=res,
                               best_score=self.best_epe)
            self.ckpt.save("latest_checkpoint", self.state, self.cur_epochs, score=res,
                           best_score=self.best_epe)
        parallel.barrier()
        return res
