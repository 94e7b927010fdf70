"""t-SNE feature visualization — port of the JAX package's ``tools/tsne.py``
(reference ``utils/tsne.py:45-245``), for ``main --tsne``.

Collects the model's decoder features (``fine_feat0``) over the train
loader and renders a 2-D t-SNE scatter colored by weather (image mode: each
image's mean feature) or semantic class (pixel mode: features at a stride).
The feature pass is the eval forward on ``device`` (the card unless the
caller asks for the CPU), which on the card launches the fused stem (K2)
three times a batch. sklearn and matplotlib are imported by ``run`` alone,
as in JAX; ``get_features`` needs neither.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..data import DataLoader, get_dataset
from ..models import build_model
from ..train.checkpoints import CheckpointManager
from ..train.state import TrainState
from ..utils import Saver, setup_logger


class Viz:
    def __init__(self, cfg, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Viz: CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        self.cfg = cfg
        self.saver = Saver(cfg)
        setup_logger(self.saver.experiment_dir, "tsne")
        self.train_dst, _ = get_dataset(cfg, seed=cfg.random_seed)
        self.loader = DataLoader(self.train_dst, cfg.batch_size, shuffle=False,
                                 num_workers=cfg.num_workers)
        # JAX initialises with PRNGKey(0); the port's weights come from seed 0
        self.model = build_model(cfg, device=self.device, seed=0)
        if cfg.resume:
            CheckpointManager.restore(cfg.resume, TrainState(self.model, None))
        self.model.eval()

    @torch.no_grad()
    def forward(self, left: np.ndarray) -> np.ndarray:
        """The eval forward's ``fine_feat0`` (B, h, w, D) of a host batch,
        as float32 on the host."""
        x = torch.as_tensor(np.asarray(left)).to(self.device).float()
        return self.model(x)["fine_feat0"].float().cpu().numpy()

    def get_features(self, mode: str = "image", max_batches: int = 16,
                     pixels_per_image: int = 256):
        """(features (N, D), labels (N,)) — image mode: the mean feature of
        each image labeled by weather; pixel mode: strided pixel features
        labeled by class."""
        feats_out, labels_out = [], []
        batches = iter(self.loader)
        try:
            for i, batch in enumerate(batches):
                if i >= max_batches:
                    break
                f = self.forward(batch["left"])  # (B, h, w, D)
                if mode == "image":
                    feats_out.append(f.mean(axis=(1, 2)))
                    labels_out.append(np.asarray(batch["weather"]).reshape(-1))
                else:
                    lbl = np.asarray(batch["label"])
                    b, h, w, d = f.shape
                    stride = max(1, int(np.sqrt(h * w / pixels_per_image)))
                    fs = f[:, ::stride, ::stride, :].reshape(-1, d)
                    ls = lbl[:, ::stride * 4, ::stride * 4].reshape(-1)[: fs.shape[0]]
                    keep = ls != 255
                    feats_out.append(fs[keep])
                    labels_out.append(ls[keep])
        finally:
            batches.close()   # stops the loader's threads
        return np.concatenate(feats_out), np.concatenate(labels_out)

    def run(self, mode: Optional[str] = None) -> str:
        from sklearn.manifold import TSNE
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mode = mode or ("image" if self.cfg.use_supcon else "pixel")
        feats, labels = self.get_features(mode=mode)
        logging.info("t-SNE over %d features (%s mode)", len(feats), mode)
        emb = TSNE(n_components=2, init="pca",
                   perplexity=min(30, max(2, len(feats) // 4))).fit_transform(feats)
        plt.figure(figsize=(8, 8))
        sc = plt.scatter(emb[:, 0], emb[:, 1], c=labels, s=4, cmap="tab20")
        plt.colorbar(sc)
        plt.title(f"t-SNE ({mode}) — {self.cfg.model}/{self.cfg.dataset}")
        out = os.path.join(self.saver.experiment_dir, "tsne.png")
        plt.savefig(out, dpi=150, bbox_inches="tight")
        plt.close()
        logging.info("saved %s", out)
        return out
