"""PASCAL VOC 2012 segmentation — port of the JAX package's ``data/voc.py``
(reference ``dataloaders/datasets/voc.py:72-162``, without the download
helper: ``root`` is an extracted VOCdevkit). No ``get_dataset`` route
reaches it, in JAX as here.

``<root>/VOC<year>/ImageSets/Segmentation/<image_set>.txt`` names the
samples (none where it is absent); each is ``JPEGImages/<name>.jpg``, read
through ``data/images.py`` (PIL), and the palette PNG
``SegmentationClass/<name>.png``, read by ``read_png`` as its palette
indices: what ``np.array(Image.open(mask))`` gives.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from .images import read_image
from .png import read_png

VOC_COLORMAP = np.array([
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (192, 0, 0),
    (64, 128, 0), (192, 128, 0), (64, 0, 128), (192, 0, 128), (64, 128, 128),
    (192, 128, 128), (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0),
    (0, 64, 128),
], np.uint8)


class VOCSegmentation:
    ignore_index = 255
    num_classes = 21

    def __init__(self, root: str, year: str = "2012", image_set: str = "train",
                 transform: Optional[Callable] = None, opts=None):
        self.root = root
        self.transform = transform
        voc = os.path.join(root, f"VOC{year}")
        split_f = os.path.join(voc, "ImageSets", "Segmentation", image_set + ".txt")
        self.images, self.masks = [], []
        if os.path.isfile(split_f):
            with open(split_f) as f:
                names = [ln.strip() for ln in f if ln.strip()]
            self.images = [os.path.join(voc, "JPEGImages", n + ".jpg") for n in names]
            self.masks = [os.path.join(voc, "SegmentationClass", n + ".png") for n in names]

    @classmethod
    def decode_target(cls, target) -> np.ndarray:
        target = np.array(target).copy()
        target[target == 255] = 0
        return VOC_COLORMAP[target]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        sample: Dict = {
            "left": read_image(self.images[index]),
            "label": read_png(self.masks[index]),
            "left_name": os.path.basename(self.images[index]),
            "frame_name": os.path.basename(self.images[index]),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
