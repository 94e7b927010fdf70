"""EDT boundary-weight visualizer — port of the repository's root
``visualize_balancing_weight.py`` (reference
``visualize_balancing_weight.py:24-121`` and the ``--viz_EDT`` dumps of
``dataloaders/datasets/acdc.py:227-263``): renders, for the first 8 train
samples, the transformed RGB crop, the EDT weight map and the
class-weighted map into ``<run_root>/viz_EDT/<i>_EDT.png``.

    python -m doubly_contrastive_semseg_tpu_torch.visualize_balancing_weight \\
        --dataset synthetic --run_root <dir>

It takes ``main``'s flags and reads the train split through the port's
``get_dataset`` and ``data/weights.py``, on the host (no model, no card).
matplotlib is imported only to draw.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import parse_args
from .data import get_dataset
from .data.weights import balanced_class_weights, compute_class_frequencies


def edt_panels(cfg) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(RGB crop float32, EDT weights, EDT × class weight) of each of the
    first 8 train samples (view 0 of a two-crop sample), the class weights
    from the first 16 samples' label frequencies."""
    train_dst, _ = get_dataset(cfg, seed=cfg.random_seed)
    freq = compute_class_frequencies(train_dst, cfg.num_classes,
                                     max_samples=min(16, len(train_dst)))
    class_w = balanced_class_weights(freq, cfg.epsilon)
    panels = []
    for i in range(min(8, len(train_dst))):
        sample = train_dst[i]
        if isinstance(sample, (list, tuple)):  # two-crop mode
            sample = sample[0]
        img = np.asarray(sample["left"], np.float32)
        edt = np.asarray(sample["label_distance_weight"])
        lbl = np.asarray(sample["label"]).copy()
        lbl[lbl == 255] = 0
        panels.append((img, edt, edt * class_w[lbl]))
    return panels


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Writes the panels' PNGs; returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = parse_args(argv)
    out_dir = os.path.join(cfg.run_root, "viz_EDT")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (img, edt, weighted) in enumerate(edt_panels(cfg)):
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(img.astype(np.uint8))
        axes[0].set_title("RGB crop")
        im1 = axes[1].imshow(edt, cmap="viridis")
        axes[1].set_title("EDT weight exp(-d/2σ)")
        fig.colorbar(im1, ax=axes[1], fraction=0.046)
        im2 = axes[2].imshow(weighted, cmap="viridis")
        axes[2].set_title("× class balance weight")
        fig.colorbar(im2, ax=axes[2], fraction=0.046)
        for ax in axes:
            ax.axis("off")
        path = os.path.join(out_dir, f"{i}_EDT.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print("saved", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
