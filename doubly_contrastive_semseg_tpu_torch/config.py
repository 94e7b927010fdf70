"""Typed configuration and the command line — port of the JAX package's
``config.py`` (``Config``, ``build_parser``, ``parse_args``; reference
``options.py:14-192``).

The flags, their defaults and ``finalize`` (``num_classes`` by dataset, the
``data_root/<dataset>`` suffix, ``val_batch_size = 1`` under ``--test_only``)
are JAX's. A ``Config`` built directly, without ``finalize``, has
``num_classes`` 19, the ACDC/Cityscapes count the JAX CLI fills in. Fields
of the port alone: ``data_root``'s default (under the home directory, where
JAX names a fixed path), ``filelist_root`` (JAX reads ``./filenames``) and
``device`` (``cuda`` or ``cpu``, where JAX reads ``JAX_PLATFORMS``) and
``--compute_dtype float64`` (float64 activations and parameters, for
exactness checks on the CPU).

``--num_devices`` N above 1 makes ``main`` start N ranks
(``parallel/launch.py``, whose ``check_devices`` refuses fewer visible GPUs
than N). ``is_stereo_run`` says which runs ``main`` gives the stereo
trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

CRITERIA = (
    "supcon_focal",
    "supcon_simclr_focal",
    "plain_focal",
    "pixelcontrast_focal",
    "supcon_pixelcontrast_focal",
    "supcon_simclr_pixelcontrast_focal",
    "crossentropy",
    "supcon_crossentropy",
    "supcon_simclr_cross_entropy",
    "supcon_none",
    "none",
    "supcon_simclr",
    "supcon",
)

DATASETS = ("cityscapes", "city_lost", "kitti_2015", "sceneflow", "kitti_mix", "acdc",
            "acdc_city", "synthetic")

MODELS = (
    "resnet18", "resnet34", "mobilenetv2", "efficientnetb0", "enet",
    "resnet18_single", "resnet18_hourglass", "resnet18_rgbd", "resnet18_back",
    "deeplabv3_resnet50", "deeplabv3plus_resnet50", "deeplabv3_resnet101",
    "deeplabv3plus_resnet101", "deeplabv3_mobilenet", "deeplabv3plus_mobilenet",
    "deeplabv3_hrnetv2_32", "deeplabv3_hrnetv2_48", "deeplabv3plus_hrnetv2_32",
    "deeplabv3plus_hrnetv2_48", "deeplabv3_xception", "deeplabv3plus_xception",
)

STEREO_DATASETS = ("sceneflow", "kitti_2015", "kitti_mix")
# every name of MODELS: the WeatherNet backbones, ENet and the DeepLab family
PORTED_MODELS = MODELS

# num_classes by dataset (reference utils/init_trainer.py:40-48)
NUM_CLASSES = {"cityscapes": 19, "kitti_2015": 19, "kitti_mix": 19, "acdc": 19,
               "acdc_city": 19, "city_lost": 20, "sceneflow": 0, "synthetic": 19}


@dataclass
class Config:
    # -- dataset (reference options.py:18-28)
    data_root: str = os.path.join(os.path.expanduser("~"), "dataset")
    dataset: str = "acdc"
    num_classes: Optional[int] = 19
    weather_num: int = 4
    num_workers: int = 4

    # -- model (options.py:30-43)
    model: str = "resnet18"
    deeplab: bool = False
    separable_conv: bool = False
    output_stride: int = 16

    # -- learning (options.py:53-80)
    epochs: int = 400
    start_epoch: int = 0
    total_itrs: int = 30_000
    lr: float = 4e-4
    last_lr: float = 1e-6
    lr_policy: str = "cos_annealing"
    weight_decay: float = 1e-4
    optimizer_policy: str = "ADAM"
    # class weights: w = 1 / log(1 + epsilon + pixel frequency)
    epsilon: float = 1e-1
    # SGD only: the seg head's lr × 10 group
    train_semantic: bool = False
    use_balanced_weights: bool = True
    finetuning: bool = False

    # -- sizes (options.py:82-96)
    batch_size: int = 8
    val_batch_size: int = 8
    step_size: int = 10_000
    crop_size: int = 384
    img_width: int = 1024
    img_height: int = 512
    val_img_width: int = 1920
    val_img_height: int = 1080
    base_size: int = 1024
    crop_val: bool = False

    # -- print / seed (options.py:98-124)
    gpu_id: str = "0"
    random_seed: int = 1
    print_freq: int = 10
    summary_freq: int = 40
    tsne: bool = False
    tsne_viz_freq: int = 100
    val_print_freq: int = 10
    val_interval: int = 100
    download: bool = False
    viz_EDT: bool = False
    no_build_summary: bool = False
    save_ckpt_freq: int = 10
    wandb: Optional[str] = None

    # -- resume (options.py:126-133)
    resume: Optional[str] = None
    continue_training: bool = False
    transfer_disparity: bool = False
    checkname: str = "test"
    coarse_features: bool = False

    # -- validate (options.py:135-138)
    test_only: bool = False
    # the val split reads the test list
    use_test_data: bool = False
    # keep one weather of the file lists
    weather_condition: Optional[str] = None

    # -- stereo-era / criterion (options.py:140-165)
    highest_loss_only: bool = False
    with_depth_level_loss: bool = False
    not_md_fusion: bool = False
    criterion: str = "none"
    no_class_weights: bool = False
    no_EDT: bool = False
    output_dir: str = "output"
    new_crop: bool = False
    disp_to_obst_ch: bool = False
    aggregation_type: str = "adaptive"
    refinement_type: str = "semantic"
    feature_similarity: str = "correlation"

    # -- hyper-parameters (options.py:167-176)
    amp: bool = False
    debug: bool = False
    acdc_cityfull: bool = False
    use_gamma_correction: bool = False
    save_val_results: bool = False
    save_each_results: bool = False

    # -- JAX package additions (no reference counterpart)
    # activations' dtype; parameters stay float32 either way
    compute_dtype: str = "bfloat16"
    # data-parallel world size; the port runs world size 1
    num_devices: Optional[int] = None
    # a torchvision ResNet or reference trainer .pth (utils/pretrained.py)
    pretrained: Optional[str] = None
    deform_impl: str = "window"
    # the reference never optimises the projection head, the weather
    # classifier or (under ADAM) WeatherNet's seg head; each flag opts one in
    train_projection: bool = False
    train_weather_clf: bool = False
    train_seg_head: bool = False
    # gradient checkpointing of each BasicBlock's (conv, BN) pairs in
    # training, with torch's reentrant recompute folding bn1/bn2's batch
    # moments into the running stats twice (reference weathernet.py:43)
    efficient: bool = True
    run_root: str = "run"
    # the host train transforms (crops, EDT weights, gamma, two views;
    # data/transforms.py); False augments on the device
    # (data/device_augment.py)
    host_augment: bool = True
    loader: str = "thread"
    # >0: every N train steps write rescue_checkpoint
    rescue_interval: int = 0
    # eval-only fused stem kernel (ops/stem.py); False runs conv→BN→ReLU→pool
    fuse_stem: bool = True
    # a torch.profiler trace of the first epoch
    trace: bool = False
    # A/B parity mode: pixel-contrast anchors are the first raster indices,
    # and the host train transforms draw the reference's legacy np.random
    # stream seeded with random_seed (data/transforms.py::ReferenceRng)
    reference_rng: bool = False
    # train-loader shuffling; False pins list order
    shuffle: bool = True
    # the synthetic dataset: train samples and generated frame HxW
    synthetic_size: int = 64
    synthetic_hw: str = "128x160"

    # -- the port's own
    # where the datasets' file lists are; JAX reads ./filenames
    filelist_root: str = "filenames"
    # where the runtime runs: the card unless the CPU is asked for
    device: str = "cuda"

    # -- derived (filled by the Trainer)
    experiment_dir: Optional[str] = None

    def finalize(self) -> "Config":
        """The derived fields the reference computes at trainer init."""
        cfg = self
        # weather_num fixup (reference options.py:188-190)
        if cfg.dataset == "acdc" and cfg.weather_num == 5:
            cfg = dataclasses.replace(cfg, weather_num=4)
        if cfg.num_classes is None:
            cfg = dataclasses.replace(cfg, num_classes=NUM_CLASSES[cfg.dataset])
        # data_root/<dataset> suffix (reference utils/init_trainer.py:50-51)
        if cfg.dataset != "synthetic" and not cfg.data_root.rstrip("/").endswith(cfg.dataset):
            cfg = dataclasses.replace(cfg, data_root=os.path.join(cfg.data_root, cfg.dataset))
        if cfg.test_only:
            cfg = dataclasses.replace(cfg, val_batch_size=1)
        return cfg

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
        """The train random crop (w, h): (768, 768) for the semantic
        datasets (reference ``dataloaders/utils.py:110-112``), (1024, 512)
        for ``city_lost`` under ``--new_crop`` (``dataloaders/utils.py:
        64-66``); for synthetic data (96, 96) on frames under 768 rows and
        the published 768² above."""
        if self.dataset == "synthetic":
            h = int(self.synthetic_hw.split("x")[0])
            return (96, 96) if h < 768 else (768, 768)
        if self.dataset == "city_lost" and self.new_crop:
            return (1024, 512)
        return (768, 768)

    @property
    def val_wh(self) -> Tuple[int, int]:
        return (self.val_img_width, self.val_img_height)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


def is_stereo_run(cfg: Config) -> bool:
    """The runs JAX's ``main.py:35-38`` sends to the disparity trainer: a
    stereo list, or synthetic data with ``--transfer_disparity``,
    ``--criterion none`` and no ``--train_semantic``."""
    return cfg.dataset in STEREO_DATASETS or (
        cfg.dataset == "synthetic" and not cfg.train_semantic
        and cfg.criterion == "none" and cfg.transfer_disparity)


def _add_bool_flag(p: argparse.ArgumentParser, name: str, default: bool, help_: str = "") -> None:
    if default:
        p.add_argument(f"--no_{name}", dest=name, action="store_false", default=True, help=help_)
    else:
        p.add_argument(f"--{name}", action="store_true", default=False, help=help_)


def build_parser() -> argparse.ArgumentParser:
    """JAX's argparse surface (``config.py:258-374``), flag for flag, plus
    ``--filelist_root`` and ``--device``."""
    p = argparse.ArgumentParser(description="doubly-contrastive semseg (PyTorch/CUDA port)")
    d = Config()

    # dataset
    p.add_argument("--data_root", type=str, default=d.data_root)
    p.add_argument("--dataset", type=str, default=d.dataset, choices=DATASETS)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--weather_num", type=int, default=d.weather_num)
    p.add_argument("--num_workers", type=int, default=d.num_workers)
    # model
    p.add_argument("--model", type=str, default=d.model, choices=MODELS)
    _add_bool_flag(p, "deeplab", False)
    _add_bool_flag(p, "separable_conv", False)
    p.add_argument("--output_stride", type=int, default=d.output_stride, choices=[8, 16])
    # learning
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--start_epoch", type=int, default=d.start_epoch)
    p.add_argument("--total_itrs", type=int, default=d.total_itrs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--last_lr", type=float, default=d.last_lr)
    p.add_argument("--lr_policy", type=str, default=d.lr_policy,
                   choices=["poly", "step", "cos", "cos_step", "cos_annealing"])
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--optimizer_policy", type=str, default=d.optimizer_policy,
                   choices=["SGD", "ADAM"])
    p.add_argument("--epsilon", type=float, default=d.epsilon)
    _add_bool_flag(p, "train_semantic", False)
    _add_bool_flag(p, "use_balanced_weights", True)
    _add_bool_flag(p, "finetuning", False)
    # sizes
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--val_batch_size", type=int, default=d.val_batch_size)
    p.add_argument("--step_size", type=int, default=d.step_size)
    p.add_argument("--crop_size", type=int, default=d.crop_size)
    p.add_argument("--img_width", type=int, default=d.img_width)
    p.add_argument("--img_height", type=int, default=d.img_height)
    p.add_argument("--val_img_width", type=int, default=d.val_img_width)
    p.add_argument("--val_img_height", type=int, default=d.val_img_height)
    p.add_argument("--base-size", dest="base_size", type=int, default=d.base_size)
    _add_bool_flag(p, "crop_val", False)
    # print / seed
    p.add_argument("--gpu_id", type=str, default=d.gpu_id)
    p.add_argument("--random_seed", type=int, default=d.random_seed)
    p.add_argument("--print_freq", type=int, default=d.print_freq)
    p.add_argument("--summary_freq", type=int, default=d.summary_freq)
    _add_bool_flag(p, "tsne", False)
    p.add_argument("--tsne_viz_freq", type=int, default=d.tsne_viz_freq)
    p.add_argument("--val_print_freq", type=int, default=d.val_print_freq)
    p.add_argument("--val_interval", type=int, default=d.val_interval)
    _add_bool_flag(p, "download", False)
    _add_bool_flag(p, "viz_EDT", False)
    _add_bool_flag(p, "no_build_summary", False)
    p.add_argument("--save_ckpt_freq", type=int, default=d.save_ckpt_freq)
    p.add_argument("--wandb", type=str, default=None)
    # resume
    p.add_argument("--resume", type=str, default=None)
    _add_bool_flag(p, "continue_training", False)
    _add_bool_flag(p, "transfer_disparity", False)
    p.add_argument("--checkname", type=str, default=d.checkname)
    _add_bool_flag(p, "coarse_features", False)
    # validate
    _add_bool_flag(p, "test_only", False)
    _add_bool_flag(p, "use_test_data", False)
    p.add_argument("--weather_condition", type=str, default=None)
    # stereo-era / criterion
    _add_bool_flag(p, "highest_loss_only", False)
    _add_bool_flag(p, "with_depth_level_loss", False)
    _add_bool_flag(p, "not_md_fusion", False)
    p.add_argument("--criterion", type=str, default=d.criterion, choices=list(CRITERIA))
    _add_bool_flag(p, "no_class_weights", False)
    _add_bool_flag(p, "no_EDT", False)
    p.add_argument("--output_dir", type=str, default=d.output_dir)
    _add_bool_flag(p, "new_crop", False)
    _add_bool_flag(p, "disp_to_obst_ch", False)
    p.add_argument("--aggregation_type", type=str, default=d.aggregation_type,
                   choices=["adaptive", "stereonet", "psmnet_basic", "psmnet_hg", "gcnet"])
    p.add_argument("--refinement_type", type=str, default=d.refinement_type,
                   choices=["semantic", "stereonet", "stereodrnet", "hourglass", "disp_sem",
                            "new1", "new2", "new3", "new4", "new5", "new9", "new10", "new12"])
    p.add_argument("--feature_similarity", type=str, default=d.feature_similarity,
                   choices=["correlation", "difference", "concat"])
    # hyper-params
    _add_bool_flag(p, "amp", False)
    _add_bool_flag(p, "debug", False)
    _add_bool_flag(p, "acdc_cityfull", False)
    _add_bool_flag(p, "use_gamma_correction", False)
    _add_bool_flag(p, "save_val_results", False)
    _add_bool_flag(p, "save_each_results", False)
    # JAX package additions
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["bfloat16", "float32", "float64"])
    p.add_argument("--num_devices", type=int, default=None)
    p.add_argument("--pretrained", type=str, default=None)
    p.add_argument("--deform_impl", type=str, default=d.deform_impl, choices=["window", "gather"])
    _add_bool_flag(p, "train_projection", False)
    _add_bool_flag(p, "train_weather_clf", False)
    _add_bool_flag(p, "train_seg_head", False)
    _add_bool_flag(p, "efficient", True)
    p.add_argument("--run_root", type=str, default=d.run_root)
    _add_bool_flag(p, "host_augment", True)
    p.add_argument("--loader", type=str, default=d.loader, choices=["thread", "grain"])
    p.add_argument("--rescue_interval", type=int, default=d.rescue_interval)
    _add_bool_flag(p, "fuse_stem", True)
    _add_bool_flag(p, "trace", False)
    _add_bool_flag(p, "reference_rng", False)
    _add_bool_flag(p, "shuffle", True)
    p.add_argument("--synthetic_size", type=int, default=d.synthetic_size)
    p.add_argument("--synthetic_hw", type=str, default=d.synthetic_hw)
    # the port's own
    p.add_argument("--filelist_root", type=str, default=d.filelist_root)
    p.add_argument("--device", type=str, default=d.device, choices=["cuda", "cpu"])
    return p


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(ns).items() if k in known}).finalize()
