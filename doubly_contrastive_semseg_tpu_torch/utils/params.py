"""Optimizer group labels of the model's parameters — port of the JAX
package's ``utils/params.py``.

ADAM (the published recipe) has two groups, as the reference builds them
(``utils/init_trainer.py:160-177``): ``fine_tune``, the ImageNet trunk, at
lr/4, and ``random_init``, everything else the reference optimises, at lr.
The weather classifier and the SupCon projection head live outside the
reference's optimised model, and its ADAM groups drop WeatherNet's seg head
(``weathernet.py:100-102``): all three are ``frozen`` unless
``train_weather_clf``, ``train_projection`` or ``train_seg_head`` opts one
in. SGD keeps the reference's name-filter groups (``init_trainer.py:
127-159``): ``sgd_specific`` (deform-conv offsets, lr × 0.1),
``sgd_semantic`` (the seg head, lr × 10, only with ``train_semantic``) and
``sgd_base`` (lr × 1).
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

import torch.nn as nn

FINE_TUNE_PREFIXES = (
    # the pretrained trunk (reference resnet_pyramid.py:187-188)
    "conv1", "bn1_0", "bn1_1", "bn1_2", "layer1", "layer2", "layer3", "layer4",
)


def label_for_path(names: Sequence[str], cfg, single_scale: bool = False) -> str:
    """The group label of the parameter whose dotted name is ``names``.
    JAX labels by its own module path: a single-scale SwiftNet
    (``single_scale``) holds its stems and trunks under ``stem[_d]`` and
    ``trunk[_d]``, names no fine-tune prefix starts, so of its modules only
    the hourglass's ``conv1b`` is ``fine_tune``, as there."""
    top = names[0]
    sgd = cfg.optimizer_policy == "SGD"
    trained = "sgd_base" if sgd else "random_init"  # opt-in heads: lr × 1
    if top == "weather_clf":
        return trained if cfg.train_weather_clf else "frozen"
    if top == "projection":
        return trained if cfg.train_projection else "frozen"
    if sgd:
        if "offset_conv" in names:
            return "sgd_specific"
        if "segmentation" in names:
            return "sgd_semantic" if cfg.train_semantic else "frozen"
        return "sgd_base"
    if "feature_extractor" in names:
        i = names.index("feature_extractor")
        sub = names[i + 1] if i + 1 < len(names) else ""
        if single_scale and re.fullmatch(r"(conv1|bn1|layer\d)(_d)?", sub):
            return "random_init"
        return "fine_tune" if sub.startswith(FINE_TUNE_PREFIXES) else "random_init"
    if "segmentation" in names:
        return "random_init" if cfg.train_seg_head else "frozen"
    return "random_init"


def label_params_for_optimizer(model: nn.Module, cfg) -> Dict[str, str]:
    """{parameter name: group label} over ``model.named_parameters()``."""
    names = [name for name, _ in model.named_parameters()]
    single_scale = any(n.startswith("net.feature_extractor.spp.") for n in names)
    return {name: label_for_path(name.split("."), cfg, single_scale) for name in names}


def count_parameters(model: nn.Module) -> int:
    """The number of parameter elements, with the stem as the reference's
    dense 7×7×3×64 kernel (the JAX package stores it as a 4×4×12×64 s2d
    kernel whose 2,880 masked-off taps its own count includes)."""
    return sum(p.numel() for p in model.parameters())
