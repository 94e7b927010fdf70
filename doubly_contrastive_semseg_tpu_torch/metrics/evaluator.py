"""Host-facing Evaluator with the reference's reporting surface.

The port's own copy of the JAX package's ``metrics/evaluator.py`` (numpy
and the standard library only), which mirrors reference
``metrics/stream_metrics.py:136-452`` (``Evaluator``): overall / per-class /
per-weather semantic confusion matrices, the weather classifier confusion
matrix + running accuracy + purity score, and the ``val_results.txt``
report appends, byte for byte as the JAX package writes them.

Accumulation differs by design: the eval step (``train/steps.py::
make_eval_step``) updates tensors *on the device* (see
``metrics/confusion.py``) and the caller hands whole matrices to
``merge_device_batch``; the numpy ``add_batch`` path is kept for API parity
and host-side use.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

CITYSCAPES_CLASS_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle", "small obstacles",
)

WEATHER_NAMES = {0: "fog", 1: "night", 2: "rain", 3: "snow", 4: "sunny"}


class Evaluator:
    def __init__(self, num_class: int, weather_num: int):
        self.num_class = num_class
        self.weather_num = weather_num
        self.reset()

    # ------------------------------------------------------------- updates
    def reset(self):
        c, w = self.num_class, self.weather_num
        self.confusion_matrix = np.zeros((c, c), np.float64)
        self.confusion_matrix_sem_weather = np.zeros((w, c, c), np.float64)
        self.confusion_matrix_weather = np.zeros((w, w), np.float64)
        self.weather_acc: list[float] = []

    def _generate_matrix(self, gt, pred):
        mask = (gt >= 0) & (gt < self.num_class)
        label = self.num_class * gt[mask].astype(int) + pred[mask].astype(int)
        count = np.bincount(label, minlength=self.num_class ** 2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image, pre_image, gt_weather=None):
        """numpy path (reference ``stream_metrics.py:337-342``)."""
        assert gt_image.shape == pre_image.shape
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)
        if gt_weather is not None:
            for i, wea in enumerate(np.asarray(gt_weather).reshape(-1)):
                self.confusion_matrix_sem_weather[int(wea)] += self._generate_matrix(
                    gt_image[i], pre_image[i])

    def add_batch_weather(self, gt_weather, weather_logits):
        gt = np.asarray(gt_weather).reshape(-1)
        pred = np.argmax(np.asarray(weather_logits), axis=-1).reshape(-1)
        for t, p in zip(gt, pred):
            self.confusion_matrix_weather[int(t), int(p)] += 1
        self.weather_acc.append(float((pred == gt).mean()))

    def merge_device_batch(self, cm, cm_weather_sem=None, cm_weather=None,
                           weather_acc: Optional[float] = None):
        """Fold matrices accumulated on-device (one host transfer per epoch)."""
        self.confusion_matrix += np.asarray(cm, np.float64)
        if cm_weather_sem is not None:
            self.confusion_matrix_sem_weather += np.asarray(cm_weather_sem, np.float64)
        if cm_weather is not None:
            self.confusion_matrix_weather += np.asarray(cm_weather, np.float64)
        if weather_acc is not None:
            self.weather_acc.append(float(weather_acc))

    # ------------------------------------------------------------- results
    @staticmethod
    def _iou(cm):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(cm) / (cm.sum(1) + cm.sum(0) - np.diag(cm))

    def Pixel_Accuracy(self):
        return np.diag(self.confusion_matrix).sum() / self.confusion_matrix.sum()

    def Pixel_Accuracy_Class(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(1)
        return np.nanmean(acc)

    def Mean_Intersection_over_Union(self, save_filename: Optional[str] = None):
        iou = self._iou(self.confusion_matrix)
        if save_filename:
            with open(save_filename, "a") as f:
                f.write("-----------IoU of each class-----------\n")
                for i in range(self.num_class):
                    f.write(f"{CITYSCAPES_CLASS_NAMES[i]:<14}: {iou[i] * 100.0:.6f}\n")
        return np.nanmean(iou)

    def Frequency_Weighted_Intersection_over_Union(self):
        freq = self.confusion_matrix.sum(1) / self.confusion_matrix.sum()
        iu = self._iou(self.confusion_matrix)
        return (freq[freq > 0] * iu[freq > 0]).sum()

    def Mean_Intersection_over_Union_each_weather(self, save_filename: Optional[str] = None):
        out: Dict[str, float] = {}
        for wea in range(self.weather_num):
            iou = self._iou(self.confusion_matrix_sem_weather[wea]) * 100.0
            miou = np.nanmean(iou)
            if save_filename:
                with open(save_filename, "a") as f:
                    name = WEATHER_NAMES.get(wea, str(wea))
                    f.write(f"---- IoU of each class in {name} ----\n")
                    for i in range(self.num_class):
                        f.write(f"{CITYSCAPES_CLASS_NAMES[i]:<14}: {iou[i]:.3f}\n")
                    f.write(f"mIoU in {name} : {miou}\n")
            out[str(wea)] = float(miou)
        return out

    def get_results(self):
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(1))
            iu = self._iou(hist)
            freq = hist.sum(1) / hist.sum()
        return {
            "Overall Acc": acc,
            "Mean Acc": acc_cls,
            "FreqW Acc": (freq[freq > 0] * iu[freq > 0]).sum(),
            "Mean IoU": np.nanmean(iu),
            "Class IoU": dict(zip(range(self.num_class), iu)),
        }

    def get_weather_results(self, save_filename: Optional[str] = None,
                            gan_based: bool = False):
        cf = self.confusion_matrix_weather
        purity = np.trace(cf) / cf.sum() if cf.sum() else 0.0
        # per-sample accuracy straight from the counts: exact on ragged final
        # batches, where the reference's mean of per-batch means
        # (stream_metrics.py:344-351) over-weights them — deliberate deviation
        if cf.sum():
            acc_mean = float(np.trace(cf) / cf.sum())
        else:
            acc_mean = float(np.mean(self.weather_acc)) if self.weather_acc else 0.0
        if save_filename:
            with open(save_filename, "a") as f:
                if gan_based:
                    f.write("\n--------- GAN-based results -------\n")
                f.write("weather confusion_matrix:\n|fog|night|rain|snow|sunny|\n")
                np.savetxt(f, cf, fmt="%-5.0f")
                f.write(f"purity score: {purity:.5f}\n")
                f.write(f"weather accuracy: {acc_mean:.5f}\n")
        return acc_mean

    @staticmethod
    def to_str(results) -> str:
        s = "\n"
        for k, v in results.items():
            if k != "Class IoU":
                s += f"{k}: {v:f}\n"
        return s
