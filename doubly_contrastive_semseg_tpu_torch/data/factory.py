"""Dataset and transform-pipeline factory — port of the JAX package's
``data/factory.py`` (reference ``dataloaders/utils.py:24-193``), for the
routes whose transforms are ported:

- ``host_augment=False`` (on-device augmentation): train is ``ToArrays``
  alone, the crops, gamma and EDT weights run on the device
  (``data/device_augment.py``); val is ``FixedResize`` → ``ToArrays``;
- the ``synthetic`` dataset, in memory.

The host train transforms (``RandomSquareCropAndScale``,
``LabelBoundaryTransform``, ``GammaCorrection``, ``TwoCropTransform``) and
the file-backed datasets are ``ROADMAP.md`` §1 item 1b: asking for them
raises ``NotImplementedError`` rather than taking another route.
"""

from __future__ import annotations

from typing import Tuple

from .synthetic import SyntheticDataset
from .transforms import Compose, FixedResize, ToArrays

_FILE_DATASETS = ("acdc", "acdc_city", "cityscapes", "kitti_2015", "kitti_mix",
                  "sceneflow", "city_lost")


def _host_augment_not_ported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"dataset {cfg.dataset!r} with host_augment=True: the host train transforms "
        "(RandomSquareCropAndScale, LabelBoundaryTransform, TwoCropTransform) are not "
        "ported yet (ROADMAP.md §1 item 1b); set host_augment=False to augment on the "
        "device")


def build_transforms(cfg, crop_wh: Tuple[int, int], seed: int = 0):
    """(train, val) transforms of a file-backed dataset: with
    ``host_augment=False`` the host only converts (JAX ``factory.py:
    57-62``)."""
    if cfg.host_augment:
        raise _host_augment_not_ported(cfg)
    return Compose([ToArrays()]), Compose(
        [FixedResize((cfg.val_img_width, cfg.val_img_height)), ToArrays()])


def get_dataset(cfg, seed: int = 0):
    """Returns (train_dst, val_dst)."""
    if cfg.dataset == "synthetic":
        if cfg.host_augment:
            raise _host_augment_not_ported(cfg)
        hw = tuple(int(v) for v in cfg.synthetic_hw.split("x"))  # (h, w)
        train_t = Compose([ToArrays()])
        val_t = Compose([FixedResize((hw[1], hw[0])), ToArrays()])
        size = 8 if cfg.debug else cfg.synthetic_size
        train_dst = SyntheticDataset(size=size, image_hw=hw,
                                     num_classes=cfg.num_classes,
                                     weather_num=cfg.weather_num,
                                     transform=train_t, seed=seed, mode="train")
        val_dst = SyntheticDataset(size=max(2, size // 4), image_hw=hw,
                                   num_classes=cfg.num_classes,
                                   weather_num=cfg.weather_num,
                                   transform=val_t, seed=seed + 1, mode="val")
        return train_dst, val_dst
    if cfg.dataset in _FILE_DATASETS:
        raise NotImplementedError(
            f"dataset {cfg.dataset!r}: the file-backed datasets are not ported yet "
            "(ROADMAP.md §1 item 1b)")
    raise ValueError(f"unknown dataset {cfg.dataset}")
