"""Trainer: the train and validate loops of one run — port of the JAX
package's ``train/trainer.py`` (reference ``trainer.py:27-666``,
``utils/init_trainer.py:21-324``), at world size 1.

Init order as in JAX: saver → datasets and the threaded ``DataLoader`` →
class weights → model → optimizer → ``--pretrained`` → checkpoint restore →
steps → summary writer → the signal rescue. The loops run eagerly on
``device`` (the card unless the caller asks for the CPU); the eval
accumulators stay on the device until the end of the pass.

Random draws are keyed so that a resumed run replays them: the
pixel-contrast anchors of update ``step`` come from a generator seeded by
``(random_seed, step)``, as JAX's ``fold_in(rng, step)``, and with
``--no_host_augment`` the crops of that update from one seeded by
``(random_seed + 1, step)``. (JAX keys its crops by ``num_iter``, which a
resume sets one past the saved step, so JAX's resumed draws are not its
uninterrupted run's; the port keys both by the update.)
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, check_ported
from ..data import DataLoader, augment_batch, get_dataset, to_device
from ..data.png import write_png
from ..data.transforms import blend_pil, thumbnail_pil
from ..data.weights import load_or_compute_class_weights
from ..metrics import Evaluator
from ..models import build_model
from ..utils import Saver, SummaryWriter, count_parameters, load_pretrained, setup_logger
from .checkpoints import CheckpointManager
from .optimizer import build_lr_schedule, build_optimizer
from .state import TrainState
from .steps import init_eval_accum, make_eval_step, make_train_step


def keyed_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """A generator on ``device`` whose draws depend on (seed, step) alone."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        check_ported(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        self.cfg = cfg
        # --- saver / logging (init_trainer.py:317-320)
        self.saver = Saver(cfg)
        self.saver.save_experiment_config()
        setup_logger(self.saver.experiment_dir, f"{cfg.model}_{cfg.dataset}")
        self.cfg.experiment_dir = self.saver.experiment_dir

        # --- data (init_trainer.py:79-95)
        self.train_dst, self.val_dst = get_dataset(cfg, seed=cfg.random_seed)
        self.train_loader = DataLoader(self.train_dst, cfg.batch_size, shuffle=cfg.shuffle,
                                       num_workers=cfg.num_workers, drop_last=True,
                                       seed=cfg.random_seed)
        self.val_loader = DataLoader(self.val_dst, cfg.val_batch_size, shuffle=False,
                                     num_workers=cfg.num_workers)
        logging.info("Dataset: %s, Train set: %d, Val set: %d",
                     cfg.dataset, len(self.train_dst), len(self.val_dst))

        # --- class-balanced weights (init_trainer.py:185-213)
        if cfg.use_balanced_weights and cfg.train_semantic and cfg.dataset != "synthetic":
            weights = load_or_compute_class_weights(cfg, self.train_dst)
        else:
            weights = np.ones((cfg.num_classes,), np.float32)
        self.class_weight = torch.as_tensor(weights, dtype=torch.float32).to(self.device)

        # --- model / optimizer
        self.model = build_model(cfg, device=self.device, seed=cfg.random_seed)
        self.evaluator = Evaluator(cfg.num_classes, cfg.weather_num)
        steps_per_epoch = max(1, len(self.train_loader))
        self.optimizer = build_optimizer(self.model, cfg, steps_per_epoch)
        self.state = TrainState(self.model, self.optimizer)
        self._lr_schedule = build_lr_schedule(cfg, steps_per_epoch, cfg.lr)

        # torchvision / reference-checkpoint weights (--pretrained <path>;
        # reference resnet_pyramid.py:397-405)
        if cfg.pretrained:
            load_pretrained(self.model, cfg.pretrained)

        n_params = count_parameters(self.model)
        self.saver.save_parameters(n_params)
        logging.info("model %s: %.2fM params on %s", cfg.model, n_params / 1e6, self.device)

        # --- checkpoints (init_trainer.py:242-281)
        self.ckpt = CheckpointManager(self.saver.checkpoint_dir)
        self.cur_epochs = 0
        self.num_iter = 0
        self.best_score = 0.0
        self.best_score_epoch = -1
        self.best_acc = 0.0
        if cfg.resume is not None:
            if not os.path.isfile(cfg.resume):
                raise RuntimeError(f"=> no checkpoint found at '{cfg.resume}'")
            self.state, meta = self.ckpt.restore(cfg.resume, self.state,
                                                 continue_training=cfg.continue_training)
            if cfg.continue_training:
                # JAX trainer.py:124-129: the next epoch, and the reference's
                # checkpoint['num_iter'] + 1 (init_trainer.py:254); a rescue
                # checkpoint resumes at the next epoch too, since the
                # threaded loader keeps no position (mid_epoch is False)
                self.cur_epochs = int(meta.get("epoch", -1)) + 1
                self.num_iter = int(meta.get("num_iter", 0)) + 1
                self.best_score = float(meta.get("best_score", 0.0))
                self.best_score_epoch = int(meta.get("best_score_epoch", -1))
                logging.info("Training state restored from %s (epoch %d)",
                             cfg.resume, self.cur_epochs)
            else:
                logging.info("Weights restored from %s", cfg.resume)
        else:
            logging.info("[!] No checkpoints found, training from init...")

        # --- steps
        self._train_step = make_train_step(self.model, cfg, self.optimizer)
        self._eval_step = make_eval_step(self.model, cfg)

        # --- summaries (init_trainer.py:322-324)
        self.writer = SummaryWriter(self.saver.experiment_dir, enable_tb=not cfg.no_build_summary)
        self.writer.init_wandb(cfg.wandb)

        self.time_val: list = []
        self.time_val_dataloader: list = []
        # per train step (epoch, loader wait s, step s to its end, the print
        # boundary's sync included); per val pass (epoch, frames, wall s)
        self.step_times: list = []
        self.val_times: list = []
        self.epoch_seconds: list = []     # main's train + validate, each epoch

        # SIGTERM/SIGINT write a rescue checkpoint, so a preempted run
        # resumes with --resume <rescue_checkpoint> --continue_training
        self._install_signal_rescue()

    def _install_signal_rescue(self) -> None:
        def rescue(signum, frame):
            for sig in (signal.SIGTERM, signal.SIGINT):   # no second rescue
                signal.signal(sig, signal.SIG_IGN)
            logging.warning("signal %s: writing rescue checkpoint...", signum)
            try:
                self._write_rescue()
                logging.warning("rescue checkpoint saved; exiting")
            finally:
                raise SystemExit(128 + signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, rescue)
            except ValueError:  # not the main thread
                return

    def _write_rescue(self) -> None:
        """``rescue_checkpoint``: the train state at the last finished
        update. The threaded loader has no position, so a resume starts the
        next epoch (JAX's rule for a checkpoint without a loader state)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ckpt.save("rescue_checkpoint", self.state, self.cur_epochs, None,
                       self.best_score, self.best_score_epoch)

    # ----------------------------------------------------------------- train
    def train(self) -> None:
        cfg = self.cfg
        logging.info("training...")
        if cfg.trace and self.cur_epochs == cfg.start_epoch:
            # --trace: a torch.profiler trace of the first epoch
            # (tensorboard --logdir <experiment_dir>/profile)
            from ..utils.profiling import trace

            with trace(os.path.join(self.saver.experiment_dir, "profile"), self.device):
                self._train_epoch()
            return
        self._train_epoch()

    def _train_epoch(self) -> None:
        cfg = self.cfg
        self.train_loader.set_epoch(self.cur_epochs)
        num_img_tr = len(self.train_loader)
        interval_loss, print_cycle, data_cycle = 0.0, 0.0, 0.0
        train_epoch_loss = 0.0

        self.writer.add_scalar("base_lr", self._current_lr(), self.cur_epochs)

        last_data_time = time.time()
        batches = iter(self.train_loader)
        try:
            for i, batch in enumerate(batches):
                wait = time.time() - last_data_time
                data_cycle += wait
                self.num_iter += 1
                step_start = time.time()

                db = to_device(batch, self.device, self.class_weight)
                step = self.state.step
                if not cfg.host_augment:
                    db.update(augment_batch(
                        db["left"], db["label"], db["weather"],
                        keyed_generator(self.device, cfg.random_seed + 1, step),
                        crop=cfg.crop_wh[0], num_classes=cfg.num_classes,
                        two_crop=cfg.use_supcon, use_gamma=cfg.use_gamma_correction))
                metrics = self._train_step(self.state, db,
                                           keyed_generator(self.device, cfg.random_seed, step))
                # summed on the device; the host syncs at the print boundaries
                interval_loss = interval_loss + metrics["total_loss"]
                train_epoch_loss = train_epoch_loss + metrics["total_loss"]

                print_cycle += time.time() - step_start

                if self.num_iter % cfg.print_freq == 0:
                    interval_loss = float(interval_loss) / cfg.print_freq
                    logging.info(
                        "Epoch: [%3d/%3d][%3d/%3d] DT: %4.2f (s), BT: %4.2f (s), "
                        "BT/img: %4.3f (s), loss: %f",
                        self.cur_epochs, cfg.epochs, i + 1, num_img_tr, data_cycle, print_cycle,
                        print_cycle / cfg.print_freq / cfg.batch_size, interval_loss)
                    self.writer.add_scalar("train/total_loss_print_freq", interval_loss,
                                           self.num_iter)
                    interval_loss, print_cycle, data_cycle = 0.0, 0.0, 0.0

                if self.num_iter % cfg.summary_freq == 0:
                    self._write_loss_summaries(metrics)

                # periodic rescue: a SIGKILL loses at most rescue_interval
                # updates (the resume starts the next epoch); skipped at the
                # epoch's end, whose save supersedes it
                if cfg.rescue_interval > 0 and i + 1 < num_img_tr \
                        and self.num_iter % cfg.rescue_interval == 0:
                    self._write_rescue()

                last_data_time = time.time()
                self.step_times.append((self.cur_epochs, wait, last_data_time - step_start))
        finally:
            batches.close()   # stops the loader's threads on any exit

        self.writer.add_scalar("train/total_loss_epoch",
                               float(train_epoch_loss) / max(num_img_tr, 1), self.cur_epochs)

    def _current_lr(self) -> float:
        return float(self._lr_schedule(int(self.state.step)))

    def _write_loss_summaries(self, metrics: Dict) -> None:
        """Per-criterion scalar families (reference trainer.py:234-290)."""
        cfg, it = self.cfg, self.num_iter
        self.writer.add_scalar("train/total_loss_summary_freq", float(metrics["total_loss"]), it)
        if "weather_loss" in metrics:
            self.writer.add_scalar("train/weather_loss_summary_freq",
                                   float(metrics["weather_loss"]), it)
            self.writer.add_scalar("train/weather_clf_acc_summary_freq",
                                   float(metrics["weather_clf_acc"]), it)
            self.best_acc = max(self.best_acc, float(metrics["weather_clf_acc"]))
        if cfg.criterion != "crossentropy":
            self.writer.add_scalar("train/sem_loss_summary_freq", float(metrics["seg_loss"]), it)
        for comp, tag in (("supcon_loss", "train/supcon_loss_summary_freq"),
                          ("simclr_loss", "train/simclr_loss_summary_freq"),
                          ("pixelcontrast_loss", "train/pixelcontrast_loss_summary_freq"),
                          ("ce_loss", "train/ce_loss_summary_freq")):
            if float(metrics.get(comp, 0.0)) != 0.0:
                self.writer.add_scalar(tag, float(metrics[comp]), it)

    # -------------------------------------------------------------- validate
    def validate(self) -> Dict:
        cfg = self.cfg
        logging.info("validation...")
        self.evaluator.reset()
        self.time_val = []
        accum = init_eval_accum(cfg, device=self.device)
        num_val = len(self.val_loader)

        start = t_pass = time.time()
        frames = 0
        for i, batch in enumerate(self.val_loader):
            self.time_val_dataloader.append(time.time() - start)
            db = to_device(batch, self.device)
            t0 = time.time()
            preds, accum = self._eval_step(db, accum)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            fwt = time.time() - t0
            if i != 0:  # skip the warm-up batch (reference trainer.py:358-368)
                self.time_val.append(fwt)
                if i % cfg.val_print_freq == 0:
                    logging.info("val [%3d/%3d] BT (bsz=%d): %.3f(s) (BT/img: %.3f(s))",
                                 i, num_val, cfg.val_batch_size, fwt,
                                 sum(self.time_val) / len(self.time_val) / cfg.val_batch_size)
            if cfg.save_val_results:
                self.save_valid_img_in_results(batch["left"], batch.get("label"),
                                               preds.cpu().numpy(), i, batch.get("frame_name"))
            frames += len(batch["left"])
            start = time.time()

        host = {k: v.cpu().numpy() for k, v in accum.items()}
        self.val_times.append((self.cur_epochs, frames, time.time() - t_pass))
        n_b = max(float(host["n_batches"]), 1.0)
        self.evaluator.merge_device_batch(host["cm"], host["cm_weather_sem"], host["cm_weather"],
                                          weather_acc=float(host["weather_acc_sum"]) / n_b)

        score = self.evaluator.get_results()
        save_filename = self.saver.save_file_return()
        weather_acc = self.evaluator.get_weather_results(save_filename)
        self.performance_test(score, weather_acc, save_filename)

        if not cfg.test_only:
            self.save_checkpoints_sem(score)
            if cfg.train_semantic and cfg.dataset != "kitti_mix":
                if score["Mean IoU"] > self.best_score:
                    self.best_score = score["Mean IoU"]
                    self.best_score_epoch = self.cur_epochs
                    self.save_checkpoints_sem(score, is_best=True)
                logging.info("best score %s (epoch: %d)", self.best_score, self.best_score_epoch)
        if self.time_val:
            logging.info("average fwd time per img: %.3f (s)",
                         sum(self.time_val) / len(self.time_val) / cfg.val_batch_size)
        return score

    def test(self) -> Dict:
        return self.validate()

    # ----------------------------------------------------------- checkpoints
    def save_checkpoints_sem(self, score, is_best: bool = False) -> None:
        name = "score_best_checkpoint" if is_best else "latest_checkpoint"
        self.ckpt.save(name, self.state, self.cur_epochs, score, self.best_score,
                       self.best_score_epoch)

    # -------------------------------------------------------------- reports
    def performance_test(self, val_score, weather_acc, save_filename) -> None:
        cfg = self.cfg
        logging.info("Validation:")
        if cfg.train_semantic and cfg.dataset != "kitti_mix":
            acc = self.evaluator.Pixel_Accuracy()
            acc_class = self.evaluator.Pixel_Accuracy_Class()
            miou = self.evaluator.Mean_Intersection_over_Union(save_filename)
            fwiou = self.evaluator.Frequency_Weighted_Intersection_over_Union()
            weather_miou = self.evaluator.Mean_Intersection_over_Union_each_weather(save_filename)
            if not cfg.test_only:
                self.writer.add_scalar("val/mIoU", miou, self.cur_epochs)
                self.writer.add_scalar("val/Acc", acc, self.cur_epochs)
                self.writer.add_scalar("val/Acc_class", acc_class, self.cur_epochs)
                self.writer.add_scalar("val/fwIoU", fwiou, self.cur_epochs)
                self.writer.add_scalar("val/Acc_weather", weather_acc, self.cur_epochs)
                for key, value in self.val_dst.weather_dict.items():
                    if str(value) in weather_miou:
                        self.writer.add_scalar("val/mIoU_" + key, weather_miou[str(value)],
                                               self.cur_epochs)
            logging.info(self.evaluator.to_str(val_score))
        else:
            miou = acc = 0.0
        self.saver.save_val_results_semantic(self.cur_epochs, miou, acc)
        if cfg.dataset == "acdc":
            logging.info("Epoch: [%d/%d] weather cls acc: %.4f / 1.0000",
                         self.cur_epochs, cfg.epochs, weather_acc)

    # ------------------------------------------------------------ viz dumps
    def save_valid_img_in_results(self, left, targets, preds, img_id,
                                  frame_names: Optional[list] = None) -> None:
        """Prediction image dumps (JAX ``trainer.py:436-478``, reference
        ``trainer.py:494-595``), written with ``write_png``: Pillow's
        ``Image.blend`` and ``thumbnail`` are ``data/transforms.py::
        blend_pil`` and ``thumbnail_pil``."""
        cfg = self.cfg
        top = "results" + (f"_{cfg.weather_condition}" if cfg.weather_condition else "")
        root = os.path.join(self.saver.experiment_dir, top)
        name = (frame_names[0].split(".")[0].replace("*", "") if frame_names else f"{img_id}")

        img = np.asarray(left)[0]
        img = ((img - img.min()) / max(img.max() - img.min(), 1e-6) * 255).astype(np.uint8)
        pred_color = self.val_dst.decode_target(preds[0].copy()).astype(np.uint8)

        def save(sub, fname, array):
            write_png(os.path.join(root, sub, fname), array, "adaptive")

        if cfg.save_each_results:
            for sub in ("left_image", "pred_sem", "overlay", "gray_pred_sem", "gt_sem"):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
            save("left_image", name + ".png", img)
            save("pred_sem", name + ".png", pred_color)
            save("overlay", name + ".png", blend_pil(img, pred_color, 0.7))
            # the eval-id map: train id → eval id is the identity except 19 → 255
            gray = preds[0].astype(np.uint8)
            gray[preds[0] == 19] = 255
            save("gray_pred_sem", name + ".png", gray)
            if targets is not None and not cfg.use_test_data:
                save("gt_sem", name + ".png",
                     self.val_dst.decode_target(np.asarray(targets)[0].copy()).astype(np.uint8))
        else:
            os.makedirs(os.path.join(root, "overall"), exist_ok=True)
            pieces = [img, pred_color]
            if targets is not None and not cfg.use_test_data:
                pieces.insert(1, self.val_dst.decode_target(
                    np.asarray(targets)[0].copy()).astype(np.uint8))
            save("overall", f"{img_id}_overall.png",
                 thumbnail_pil(np.concatenate(pieces, axis=0), (720, 720)))
