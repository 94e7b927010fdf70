"""Synthetic in-memory datasets — port of the JAX package's
``data/synthetic.py``: ``SyntheticDataset``, with the sample contract of the
file-backed ones, and ``SyntheticStereoDataset``, the stereo pairs of the
synthetic disparity route.

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


class SyntheticStereoDataset:
    """Random stereo pairs with exact ground-truth disparity (JAX
    ``SyntheticStereoDataset``), bit for bit JAX's for a seed and index:
    smoothed noise as the left view, the right view the left shifted by a
    constant integer disparity drawn in [2, max_disp − 2), zeros where it
    has no source; the disparity map that constant, 0 (invalid) in the
    left border's ``d`` columns; a random int64 label map. Float32 images
    on the 0-255 scale."""

    def __init__(self, size: int = 8, image_hw=(64, 96), max_disp: int = 16, seed: int = 0):
        self.size = size
        self.image_hw = image_hw
        self.max_disp = max_disp
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng(self.seed * 9176 + index)
        h, w = self.image_hw
        left = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        # a smoothed texture, so that bilinear matching is well posed
        for _ in range(2):
            left = np.apply_along_axis(
                lambda v: np.convolve(v, np.ones(5) / 5, mode="same"), 1, left)
        d = float(rng.integers(2, self.max_disp - 2))
        right = np.zeros_like(left)
        right[:, : w - int(d)] = left[:, int(d):]
        disp = np.full((h, w), d, np.float32)
        disp[:, : int(d)] = 0.0
        return {
            "left": left,
            "right": right,
            "disp": disp,
            "label": rng.integers(0, 19, (h, w)).astype(np.int64),
            "left_name": f"stereo/{index}",
            "frame_name": f"{index}",
        }


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
