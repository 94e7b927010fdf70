"""Optimizer and learning-rate schedules — port of the JAX package's
``train/optimizer.py`` (reference ``utils/init_trainer.py:127-177,299-306``).

ADAM (the published recipe): ``torch.optim.Adam`` with betas (0.9, 0.99)
and its L2 weight decay into the gradient (not AdamW), in two groups:
``random_init`` at (lr, weight_decay) and ``fine_tune`` at (lr/4,
weight_decay/4). SGD (momentum 0.9, decay into the gradient) keeps the
reference's three trained groups at lr × 0.1, × 1 and × 10. Frozen
parameters are in no group, so the optimizer never moves them.

Each group keeps its own base lr in ``group["base_lr"]``; ``set_lr`` sets
every group's lr for a step from the schedule of ``cfg.lr_policy``:
``cos_annealing`` (torch ``CosineAnnealingLR`` stepped once an epoch, from
the group's base lr down to the shared ``last_lr``), ``poly``, ``step`` and
``cos``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..utils.params import label_params_for_optimizer

FINE_TUNE_FACTOR = 4.0


def cosine_annealing_schedule(base_lr: float, last_lr: float, epochs: int,
                              steps_per_epoch: int) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR`` stepped once an epoch:
    lr(e) = last + ½ (base − last)(1 + cos(π e / T))."""

    def schedule(step: int) -> float:
        t = min(step // max(steps_per_epoch, 1), epochs)
        return last_lr + 0.5 * (base_lr - last_lr) * (1 + math.cos(math.pi * t / epochs))

    return schedule


def build_lr_schedule(cfg, steps_per_epoch: int, base_lr: float) -> Callable[[int], float]:
    """The schedule of ``cfg.lr_policy`` for a group whose initial lr is
    ``base_lr`` (the cosine anneals every group to the same ``last_lr``,
    ``init_trainer.py:301-306``)."""
    policy = cfg.lr_policy
    if policy == "cos_annealing":
        return cosine_annealing_schedule(base_lr, cfg.last_lr, cfg.epochs, steps_per_epoch)
    total = max(1, cfg.epochs * steps_per_epoch)
    if policy == "poly":
        return lambda step: base_lr * (1.0 - min(step, total) / total) ** 0.9
    if policy == "step":
        return lambda step: base_lr * 0.1 ** (step // max(cfg.step_size, 1))
    if policy in ("cos", "cos_step"):
        return lambda step: 0.5 * base_lr * (1 + math.cos(math.pi * min(step, total) / total))
    raise NotImplementedError(policy)


def build_optimizer(model: torch.nn.Module, cfg, steps_per_epoch: int) -> torch.optim.Optimizer:
    """The optimizer of ``cfg.optimizer_policy`` over the model's trained
    parameter groups (``utils/params.py`` labels); each group carries its
    label, ``base_lr`` and ``steps_per_epoch`` for ``set_lr``."""
    labels = label_params_for_optimizer(model, cfg)
    if cfg.optimizer_policy == "ADAM":
        hyper = {"random_init": (cfg.lr, cfg.weight_decay),
                 "fine_tune": (cfg.lr / FINE_TUNE_FACTOR,
                               cfg.weight_decay / FINE_TUNE_FACTOR)}
    elif cfg.optimizer_policy == "SGD":
        hyper = {"sgd_specific": (cfg.lr * 0.1, cfg.weight_decay),
                 "sgd_base": (cfg.lr, cfg.weight_decay),
                 "sgd_semantic": (cfg.lr * 10.0, cfg.weight_decay)}
    else:
        raise NotImplementedError(cfg.optimizer_policy)
    params = dict(model.named_parameters())
    groups = []
    for label, (lr, wd) in hyper.items():
        members = [params[n] for n, lab in labels.items() if lab == label]
        if members:
            groups.append({"params": members, "lr": lr, "weight_decay": wd,
                           "label": label, "base_lr": lr,
                           "steps_per_epoch": steps_per_epoch})
    if cfg.optimizer_policy == "ADAM":
        return torch.optim.Adam(groups, betas=(0.9, 0.99), eps=1e-8)
    return torch.optim.SGD(groups, momentum=0.9)


def build_stereo_optimizer(model: torch.nn.Module, cfg,
                           steps_per_epoch: int) -> torch.optim.Optimizer:
    """The stereo trainer's optimizer (JAX ``trainer_stereo.py``:
    ``optax.adam(build_lr_schedule(cfg, steps_per_epoch), b1=0.9,
    b2=0.99)``): Adam over every parameter in one group at ``cfg.lr``'s
    schedule, without weight decay."""
    group = {"params": list(model.parameters()), "lr": cfg.lr, "weight_decay": 0.0,
             "label": "stereo", "base_lr": cfg.lr, "steps_per_epoch": steps_per_epoch}
    return torch.optim.Adam([group], betas=(0.9, 0.99), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, cfg, step: int) -> None:
    """Sets each group's lr for update number ``step`` (0 for the first)."""
    for group in optimizer.param_groups:
        group["lr"] = build_lr_schedule(cfg, group["steps_per_epoch"],
                                        group["base_lr"])(step)
