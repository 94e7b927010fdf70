"""Checkpoints on ``torch.save`` with the JAX package's save/restore policy —
port of ``train/checkpoints.py`` (reference ``trainer.py:392-421``,
``utils/saver.py:45-70``, ``utils/init_trainer.py:242-281``).

``latest_checkpoint`` is saved every validation, ``score_best_checkpoint``
when the val mIoU improves, ``rescue_checkpoint`` on SIGTERM/SIGINT and
every ``--rescue_interval`` steps, each as one file under ``checkpoints/``
holding the model ``state_dict``, the optimizer ``state_dict`` (its groups
keep ``label``, ``base_lr`` and ``steps_per_epoch``), ``step`` and the
meta, with JAX's ``<name>.meta.json`` sidecar beside it. A file is written
under a temporary name and moved into place with ``os.replace``, so a kill
during a save leaves the previous checkpoint whole.

Restore merges the weights and BN statistics by name and shape (the
``strict=False`` analogue of JAX's merge by path) and takes the optimizer
state and ``step`` only with ``continue_training``.
"""

from __future__ import annotations

import io
import json
import logging
import os
from typing import Dict, Optional, Tuple

import torch

from ..utils.pretrained import merge_state_dict
from .state import TrainState


def _meta(epoch: int, step: int, score: Optional[Dict], best_score: float,
          best_score_epoch: int, mid_epoch: bool = False) -> Dict:
    """JAX ``checkpoints.py::_meta``'s keys and values. ``mid_epoch`` marks
    a checkpoint that resumes inside its epoch, which needs a loader
    position; the threaded loader has none, so the port writes False."""
    return {
        "epoch": int(epoch),
        "num_iter": int(step),
        "score": {k: float(v) for k, v in (score or {}).items() if k != "Class IoU"},
        "best_score": float(best_score),
        "best_score_epoch": int(best_score_epoch),
        "mid_epoch": bool(mid_epoch),
    }


def atomic_write(path: str, data: bytes) -> None:
    """Writes ``data`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: readers see the old file or the new one."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state: TrainState, epoch: int, score: Optional[Dict] = None,
             best_score: float = 0.0, best_score_epoch: int = -1) -> str:
        """Writes ``<name>`` and ``<name>.meta.json``; returns the path. CUDA
        tensors are read from the card as the payload is serialised."""
        meta = _meta(epoch, state.step, score, best_score, best_score_epoch)
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step), "meta": meta}
        buf = io.BytesIO()
        torch.save(payload, buf)
        path = self.path(name)
        atomic_write(path, buf.getvalue())
        atomic_write(path + ".meta.json", json.dumps(meta).encode())
        return path

    @staticmethod
    def restore(path: str, state: TrainState,
                continue_training: bool = False) -> Tuple[TrainState, Dict]:
        """Loads ``path`` onto ``state`` in place, with ``map_location`` the
        model's device; returns (state, meta)."""
        model = state.model
        device = next(model.parameters()).device
        blob = torch.load(path, map_location=device, weights_only=True)
        merge_state_dict(model, blob["model"], path)
        if continue_training:
            osd = blob["optimizer"]
            for s in osd["state"].values():
                # a fresh optimizer keeps Adam's step counts on the host
                # unless capturable or fused; keep the restored ones there too
                if torch.is_tensor(s.get("step")) and not any(
                        g.get("capturable") or g.get("fused") for g in osd["param_groups"]):
                    s["step"] = s["step"].cpu()
            try:
                state.optimizer.load_state_dict(osd)
            except ValueError as e:
                logging.warning("optimizer state of %s does not fit this optimizer (%s); "
                                "keeping a fresh one", path, e)
            state.step = int(blob["step"])
        return state, dict(blob.get("meta", {}))

