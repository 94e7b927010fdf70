"""Synthetic in-memory dataset with the sample contract of the file-backed
ones — port of the JAX package's ``data/synthetic.py::SyntheticDataset``.

It backs ``dataset="synthetic"``, so the train and validate paths run end
to end without a dataset on disk. Frames are blocky random class layouts
rendered to RGB with noise, so the losses have structure to learn. Each
index and seed gives the same frame, weather and names as the JAX dataset,
byte for byte; where JAX yields PIL images, this one yields numpy arrays
(uint8 (H, W, 3) ``left``, uint8 (H, W) ``label``), which is what JAX's
``ToArrays`` turns them into.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .labels import TRAIN_ID_TO_COLOR, WEATHER_DICT


class SyntheticDataset:
    ignore_index = 255
    weather_dict = WEATHER_DICT

    def __init__(self, size: int = 16, image_hw=(128, 128), num_classes: int = 19,
                 weather_num: int = 4, transform: Optional[Callable] = None,
                 seed: int = 0, mode: str = "train", opts=None):
        self.size = size
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.weather_num = weather_num
        self.transform = transform
        self.seed = seed
        self.mode = mode
        self._frame_cache: Dict[int, tuple] = {}

    @classmethod
    def decode_target(cls, target):
        target = np.array(target).copy()
        target[target == 255] = 19
        return TRAIN_ID_TO_COLOR[target]

    def __len__(self) -> int:
        return self.size

    # distinct generated frames; beyond this, indices reuse them, so a large
    # synthetic_size measures the device and not numpy's generator
    _MAX_UNIQUE = 64

    def _frame(self, index: int):
        """The (image, label) of ``index``, generated once and kept
        read-only: samples share these arrays."""
        key = index % self._MAX_UNIQUE
        cached = self._frame_cache.get(key)
        if cached is not None:
            return cached
        rng = np.random.default_rng(self.seed * 100003 + key)
        h, w = self.image_hw
        # blocky label layout: a few random rectangles of random classes
        label = np.full((h, w), rng.integers(0, self.num_classes), np.uint8)
        for _ in range(6):
            c = int(rng.integers(0, self.num_classes))
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1, x1 = int(rng.integers(y0 + 4, h)), int(rng.integers(x0 + 4, w))
            label[y0:y1, x0:x1] = c
        # a small ignore patch
        label[: h // 8, : w // 8] = 255
        color = self.decode_target(label).astype(np.float32)
        noise = rng.normal(0, 12, color.shape)
        img = np.clip(color + noise, 0, 255).astype(np.uint8)
        img.setflags(write=False)
        label.setflags(write=False)
        self._frame_cache[key] = (img, label)
        return img, label

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng(self.seed * 100003 + index)
        img, label = self._frame(index)
        sample: Dict = {
            "left": img,
            "label": label,
            "weather": np.array([int(rng.integers(0, self.weather_num))]),
            "left_name": f"synthetic/{index}.png",
            "frame_name": f"{index}*",
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
