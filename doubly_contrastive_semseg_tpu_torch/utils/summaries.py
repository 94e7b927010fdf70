"""Metrics writer — port of the JAX package's ``utils/summaries.py``
(reference ``utils/summaries.py:8-84`` and the wandb mirror of
``main.py:13-16``): every scalar lands in ``metrics.jsonl``; TensorBoard
only when ``torch.utils.tensorboard`` imports; wandb only when asked for
and importable."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class SummaryWriter:
    def __init__(self, log_dir: str, enable_tb: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter as TBWriter

                self._tb = TBWriter(log_dir=log_dir)
            except Exception:
                self._tb = None
        self._wandb = None

    def init_wandb(self, project: Optional[str]) -> None:
        if project is None:
            return
        try:
            import wandb

            wandb.init(project=project, sync_tensorboard=True)
            self._wandb = wandb
        except Exception:
            self._wandb = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value})

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
