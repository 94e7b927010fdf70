"""The model fields of the JAX package's ``Config`` that ``build_model`` reads.

Defaults match ``doubly_contrastive_semseg_tpu/config.py`` (``num_classes``
is the ACDC/Cityscapes 19 the JAX CLI fills in per dataset). The port has
no command line yet, so there is no argparse surface here.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    model: str = "resnet18"
    num_classes: int = 19
    weather_num: int = 4
    # activations' dtype; parameters stay float32 either way
    compute_dtype: str = "bfloat16"
    # eval-only fused stem kernel (ops/stem.py); False runs conv→BN→ReLU→pool
    fuse_stem: bool = True
    # gradient checkpointing in training; read by the training slice
    efficient: bool = True
