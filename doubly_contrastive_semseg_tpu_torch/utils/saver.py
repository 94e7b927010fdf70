"""The run directory — port of the JAX package's ``utils/saver.py``
(reference ``utils/saver.py:11-116``).

Layout: ``<run_root>/<dataset>/<checkname>/<timestamp>/`` holding
``args.json``, ``command.txt``, ``parameters.txt``, ``val_results.txt`` and
``checkpoints/`` (``train/checkpoints.py``: ``torch.save`` files where JAX
writes orbax directories)."""

from __future__ import annotations

import os
import sys
from datetime import datetime
from typing import Optional


class Saver:
    """The run directory ``experiment_dir`` (a new timestamped one unless
    given); with ``write`` off (the ranks other than 0, which share rank
    0's directory) the ``save_*`` methods write nothing and
    ``checkpoint_dir`` makes no directory."""

    def __init__(self, cfg, experiment_dir: Optional[str] = None, write: bool = True):
        self.cfg, self.write = cfg, write
        if experiment_dir is None:
            ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            experiment_dir = os.path.join(cfg.run_root, cfg.dataset, cfg.checkname, ts)
        self.experiment_dir = experiment_dir
        if write:
            os.makedirs(self.experiment_dir, exist_ok=True)
        self.results_file = os.path.join(self.experiment_dir, "val_results.txt")

    def save_experiment_config(self) -> None:
        if not self.write:
            return
        with open(os.path.join(self.experiment_dir, "args.json"), "w") as f:
            f.write(self.cfg.to_json())
        with open(os.path.join(self.experiment_dir, "command.txt"), "w") as f:
            f.write(" ".join(sys.argv) + "\n")

    def save_parameters(self, n_params: int) -> None:
        if not self.write:
            return
        with open(os.path.join(self.experiment_dir, "parameters.txt"), "w") as f:
            f.write(f"Total parameters: {n_params} ({n_params / 1e6:.2f}M)\n")

    def save_file_return(self) -> str:
        return self.results_file

    def save_val_results_semantic(self, epoch: int, miou: float, acc: float) -> None:
        if not self.write:
            return
        with open(self.results_file, "a") as f:
            f.write(f"epoch {epoch}: mIoU {miou:.6f}, acc {acc:.6f}\n")

    @property
    def checkpoint_dir(self) -> str:
        d = os.path.join(self.experiment_dir, "checkpoints")
        if self.write:
            os.makedirs(d, exist_ok=True)
        return d
