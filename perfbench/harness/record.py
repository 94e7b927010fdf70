"""What a run hands to the metric readers and to the result line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from .trace import Trace

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet) at the 700 W limit
PEAKS = {"bf16_tensor_flops": 989e12, "tf32_tensor_flops": 494.7e12, "f32_flops": 67e12,
         "hbm_bytes_per_s": 3.35e12}


@dataclass
class Record:
    kind: str                                   # "train" or "serve"
    cell: dict
    config: dict
    traffic: dict
    e2e: Dict[str, float] = field(default_factory=dict)
    host: Dict[str, list] = field(default_factory=dict)       # host-clock readings
    trace: Optional[Trace] = None
    window_s: float = 0.0                       # the measured window's length
    iterations: int = 0                         # steps or batches done in it
    flops_per_iteration: Optional[float] = None
    numbers: Dict[str, Optional[float]] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    device: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=lambda: dict(PEAKS))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
