"""Dataset and transform-pipeline factory — port of the JAX package's
``data/factory.py`` (reference ``dataloaders/utils.py:24-193``):

- ``host_augment=True`` (the default): train is RandomSquareCropAndScale
  (the crop) → SetTargetSize → LabelBoundaryTransform (EDT weights) →
  [GammaCorrection] → ToArrays, in TwoCropTransform when the criterion has
  'supcon'; val is FixedResize → [GammaCorrection] → ToArrays;
- ``host_augment=False`` (on-device augmentation): train is ``ToArrays``
  alone, the crops, gamma and EDT weights run on the device
  (``data/device_augment.py``); val is FixedResize → ToArrays;
- ``city_lost`` takes its own pipelines whatever ``host_augment`` says, as
  in JAX: CropBlackArea first, then the host crops (1024×512 under
  ``--new_crop``), no gamma; val CropBlackArea → FixedResize → ToArrays;
  ``--not_md_fusion`` keeps Lost&Found alone;
- the datasets ``acdc``, ``acdc_city``, ``cityscapes``, ``city_lost``, the
  stereo lists ``kitti_2015``, ``kitti_mix`` and ``sceneflow`` (files under
  ``data_root``, file lists under ``filelist_root``) and ``synthetic`` (in
  memory).

As in JAX, a stereo list here takes the semantic pipelines with its
disparity loaded; ``main`` sends those datasets to the stereo trainer,
whose pipelines are ``train/trainer_stereo.py::stereo_dataset``'s.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .acdc import ACDC
from .acdc_city import ACDC_City
from .citylostfound import CityLostFound, LostFound
from .cityscapes import Cityscapes
from .synthetic import SyntheticDataset
from .transforms import (
    Compose,
    CropBlackArea,
    FixedResize,
    GammaCorrection,
    LabelBoundaryTransform,
    RandomSquareCropAndScale,
    ReferenceRng,
    SetTargetSize,
    ThreadSafeRng,
    ToArrays,
    TwoCropTransform,
)

# dataset-mean fill of the crop padding (reference dataloaders/utils.py:28-30)
MEAN_RGB = tuple(np.uint8([73.15, 82.90, 72.3]))


def _train_rng(cfg, seed: int):
    """The augmentation draws: a lock-guarded Generator the loader's threads
    share, or under ``reference_rng`` the reference program's legacy
    ``np.random`` stream (single-worker, unshuffled runs only)."""
    if cfg.reference_rng:
        return ReferenceRng(cfg.random_seed)
    return ThreadSafeRng(np.random.default_rng(seed))


def _host_train(cfg, crop_wh: Tuple[int, int], rng, gamma: bool, first=()):
    """JAX's host train pipeline (``factory.py:64-71``, ``:110-119``,
    ``:134-143``), after the transforms ``first``."""
    tech = [
        *first,
        RandomSquareCropAndScale(crop_wh, mean=MEAN_RGB, ignore_id=255, rng=rng),
        SetTargetSize(target_size=crop_wh,
                      target_size_feats=(crop_wh[0] // 4, crop_wh[1] // 4)),
        LabelBoundaryTransform(num_classes=cfg.num_classes, reduce=True),
    ]
    if gamma:
        tech.append(GammaCorrection())
    tech.append(ToArrays())
    transform = Compose(tech)
    return TwoCropTransform(transform) if cfg.use_supcon else transform


def build_transforms(cfg, crop_wh: Tuple[int, int], seed: int = 0):
    """(train, val) transforms of a file-backed dataset (JAX ``factory.py:
    48-71``)."""
    if not cfg.host_augment:
        # the host only converts; the crops, EDT weights, gamma and two
        # views run on the device (data/device_augment.py)
        return Compose([ToArrays()]), Compose(
            [FixedResize((cfg.val_img_width, cfg.val_img_height)), ToArrays()])
    gamma = cfg.use_gamma_correction
    val_tech = [FixedResize((cfg.val_img_width, cfg.val_img_height))]
    if gamma:
        val_tech.append(GammaCorrection())
    val_tech.append(ToArrays())
    return _host_train(cfg, crop_wh, _train_rng(cfg, seed), gamma), Compose(val_tech)


def get_dataset(cfg, seed: int = 0):
    """Returns (train_dst, val_dst)."""
    if cfg.dataset == "acdc":
        train_t, val_t = build_transforms(cfg, cfg.crop_wh, seed)
        train_dst = ACDC(root=cfg.data_root, mode="train", transform=train_t, opts=cfg,
                         filelist_root=cfg.filelist_root)
        val_mode = "test" if cfg.use_test_data else "val"
        val_dst = ACDC(root=cfg.data_root, mode=val_mode, transform=val_t, opts=cfg,
                       filelist_root=cfg.filelist_root)
        return train_dst, val_dst
    if cfg.dataset == "acdc_city":
        train_t, val_t = build_transforms(cfg, cfg.crop_wh, seed)
        kw = dict(opts=cfg, filelist_root=cfg.filelist_root)
        return (ACDC_City(root=cfg.data_root, mode="train", transform=train_t, **kw),
                ACDC_City(root=cfg.data_root, mode="val", transform=val_t, **kw))
    if cfg.dataset in ("cityscapes", "kitti_2015", "kitti_mix", "sceneflow"):
        train_t, val_t = build_transforms(cfg, cfg.crop_wh, seed)
        kw = dict(dataset_name=cfg.dataset, opts=cfg, filelist_root=cfg.filelist_root)
        return (Cityscapes(root=cfg.data_root, mode="train", transform=train_t, **kw),
                Cityscapes(root=cfg.data_root, mode="val", transform=val_t, **kw))
    if cfg.dataset == "city_lost":
        train_t = _host_train(cfg, cfg.crop_wh, _train_rng(cfg, seed), gamma=False,
                              first=[CropBlackArea()])
        val_t = Compose([CropBlackArea(), FixedResize((cfg.val_img_width, cfg.val_img_height)),
                         ToArrays()])
        cls = LostFound if cfg.not_md_fusion else CityLostFound
        kw = dict(opts=cfg, filelist_root=cfg.filelist_root)
        return (cls(root=cfg.data_root, mode="train", transform=train_t, **kw),
                cls(root=cfg.data_root, mode="val", transform=val_t, **kw))
    if cfg.dataset == "synthetic":
        hw = tuple(int(v) for v in cfg.synthetic_hw.split("x"))  # (h, w)
        if cfg.host_augment:
            # no gamma on the synthetic route, as in JAX (factory.py:134-143)
            train_t = _host_train(cfg, cfg.crop_wh, _train_rng(cfg, seed), gamma=False)
        else:
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
    raise ValueError(f"unknown dataset {cfg.dataset}")
