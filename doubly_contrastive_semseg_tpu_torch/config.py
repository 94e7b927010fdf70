"""The fields of the JAX package's ``Config`` that the port reads.

Defaults match ``doubly_contrastive_semseg_tpu/config.py`` (``num_classes``
is the ACDC/Cityscapes 19 the JAX CLI fills in per dataset). The port has
no command line yet, so there is no argparse surface here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # -- data (JAX config.py:71-75, 92-111, 155-157, 172, 180-184)
    data_root: str = os.path.join(os.path.expanduser("~"), "dataset")
    num_workers: int = 4
    # class weights: w = 1 / log(1 + epsilon + pixel frequency)
    epsilon: float = 1e-1
    use_balanced_weights: bool = True
    val_batch_size: int = 8
    crop_size: int = 384
    val_img_width: int = 1920
    val_img_height: int = 1080
    random_seed: int = 1
    debug: bool = False
    use_gamma_correction: bool = False
    # the val split reads the test list (JAX config.py:133)
    use_test_data: bool = False
    # keep one weather of the file lists (JAX config.py:134)
    weather_condition: Optional[str] = None
    # where the datasets' file lists are; JAX reads ./filenames
    filelist_root: str = "filenames"
    # the host train transforms (crops, EDT weights, gamma, two views;
    # data/transforms.py); False augments on the device
    # (data/device_augment.py)
    host_augment: bool = True
    # train-loader shuffling; False pins list order
    shuffle: bool = True
    # the synthetic dataset: train samples and generated frame HxW
    synthetic_size: int = 64
    synthetic_hw: str = "128x160"

    # -- model
    model: str = "resnet18"
    num_classes: int = 19
    weather_num: int = 4
    # activations' dtype; parameters stay float32 either way
    compute_dtype: str = "bfloat16"
    # eval-only fused stem kernel (ops/stem.py); False runs conv→BN→ReLU→pool
    fuse_stem: bool = True
    # gradient checkpointing of each BasicBlock's (conv, BN) pairs in
    # training, with torch's reentrant recompute folding bn1/bn2's batch
    # moments into the running stats twice (reference weathernet.py:43)
    efficient: bool = True

    # -- training (JAX config.py:84-101, 140-142, 167-177)
    dataset: str = "acdc"
    criterion: str = "none"
    lr: float = 4e-4
    last_lr: float = 1e-6
    epochs: int = 400
    lr_policy: str = "cos_annealing"
    weight_decay: float = 1e-4
    optimizer_policy: str = "ADAM"
    step_size: int = 10_000
    batch_size: int = 8
    no_class_weights: bool = False
    no_EDT: bool = False
    # the reference never optimises the projection head, the weather
    # classifier or (under ADAM) WeatherNet's seg head; each flag opts one in
    train_projection: bool = False
    train_weather_clf: bool = False
    train_seg_head: bool = False
    # SGD only: the seg head's lr × 10 group
    train_semantic: bool = False
    # A/B parity mode: pixel-contrast anchors are the first raster indices,
    # and the host train transforms draw the reference's legacy np.random
    # stream seeded with random_seed (data/transforms.py::ReferenceRng)
    reference_rng: bool = False

    @property
    def ignore_index(self) -> int:
        return 255

    @property
    def use_supcon(self) -> bool:
        """Two-view batches and image-level contrast (reference
        ``trainer.py:66-72``)."""
        return "supcon" in self.criterion

    @property
    def use_pixelcontrast(self) -> bool:
        return "pixelcontrast" in self.criterion

    @property
    def crop_wh(self) -> Tuple[int, int]:
        """The train random crop: (768, 768) for the semantic datasets
        (reference ``dataloaders/utils.py:110-112``); for synthetic data
        (96, 96) on frames under 768 rows and the published 768² above.
        (JAX's city_lost 1024×512 crop waits for that dataset, ``ROADMAP.md``
        §1 item 1c.)"""
        if self.dataset == "synthetic":
            h = int(self.synthetic_hw.split("x")[0])
            return (96, 96) if h < 768 else (768, 768)
        return (768, 768)

    @property
    def val_wh(self) -> Tuple[int, int]:
        return (self.val_img_width, self.val_img_height)
