"""Train state — the port's counterpart of the JAX package's
``train/state.py``. JAX threads an immutable pytree of params, BN stats and
optimizer state through the step; here the model holds its parameters and
BN running stats, the optimizer its moments, and the state the step count
(``num_iter`` in the reference), which the lr schedule reads."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.weathernet import DCSSModel


@dataclass
class TrainState:
    model: DCSSModel
    optimizer: torch.optim.Optimizer
    step: int = 0
