"""Cityscapes with Lost&Found, 20 classes — port of the JAX package's
``data/citylostfound.py`` (reference ``dataloaders/datasets/
citylostfound.py`` and ``lostfound.py``): the 19 Cityscapes classes and
class 19, small obstacles.

``LostFound`` reads ``<filelist_root>/city_lost/lostfound_{mode}.txt`` (no
samples where that list is absent, as in JAX), one ``left [...] gt`` a
line under ``root``; its labelIds become road (id 1 → 0), obstacle (ids ≥ 2
→ 19) and ignore (id 0). ``CityLostFound`` adds the Cityscapes frames of
``<filelist_root>/cityscapes/cityscapes_semantic_{mode}.txt`` under
``root`` with "city_lost" replaced by "cityscapes", labelled through the
clamped id → train-id table. Samples hold ``left``, ``label``,
``left_name`` and ``frame_name``; no ``weather``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .acdc import CITYSCAPES_ID_TO_TRAIN_ID, read_text_lines
from .images import read_image
from .labels import TRAIN_ID_TO_COLOR

# the 19 Cityscapes colours, magenta obstacles, black for the ignore id
TRAIN_ID_TO_COLOR_CLF = np.concatenate(
    [TRAIN_ID_TO_COLOR[:19], np.array([[255, 0, 255], [0, 0, 0]], np.uint8)], axis=0)


def _encode_lostfound(target: np.ndarray) -> np.ndarray:
    """Lost&Found gtCoarse labelIds: 0 out of the ROI (ignore), 1 road,
    ≥ 2 obstacles."""
    out = np.full(target.shape, 255, np.uint8)
    out[target == 1] = 0
    out[target >= 2] = 19
    return out


class LostFound:
    ignore_index = 255
    weather_dict = {"sunny": 4}

    def __init__(self, root: str, dataset_name: str = "city_lost", mode: str = "train",
                 transform: Optional[Callable] = None, opts=None,
                 filelist_root: str = "filenames"):
        self.root = root
        self.transform = transform
        list_path = os.path.join(filelist_root, "city_lost", f"lostfound_{mode}.txt")
        self.samples: List[Dict] = []
        if os.path.isfile(list_path):
            for line in read_text_lines(list_path):
                parts = line.split()
                self.samples.append({
                    "left": os.path.join(root, parts[0]),
                    "left_name": parts[0].split("/", 1)[-1],
                    "frame_name": os.path.basename(parts[0]),
                    "label": os.path.join(root, parts[-1]) if len(parts) > 1 else None,
                    "kind": "lostfound",
                })

    @classmethod
    def decode_target(cls, target) -> np.ndarray:
        target = np.array(target).copy()
        target[target == 255] = 20
        return TRAIN_ID_TO_COLOR_CLF[target]

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, rec: Dict) -> Dict:
        sample: Dict = {
            "left": read_image(rec["left"]),
            "left_name": rec["left_name"],
            "frame_name": rec["frame_name"],
        }
        if rec["label"]:
            raw = read_image(rec["label"], mode=None)
            if rec["kind"] == "lostfound":
                sample["label"] = _encode_lostfound(raw)
            else:
                sample["label"] = CITYSCAPES_ID_TO_TRAIN_ID[
                    np.minimum(raw.astype(np.uint8), len(CITYSCAPES_ID_TO_TRAIN_ID) - 1)]
        return sample

    def __getitem__(self, index: int) -> Dict:
        sample = self._load(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class CityLostFound(LostFound):
    """Lost&Found and Cityscapes: the Cityscapes frames keep their 19
    classes (the obstacle class never appears in them), Lost&Found gives
    road, obstacle and ignore."""

    def __init__(self, root: str, dataset_name: str = "city_lost", mode: str = "train",
                 transform: Optional[Callable] = None, opts=None,
                 filelist_root: str = "filenames"):
        super().__init__(root, dataset_name, mode, transform, opts, filelist_root)
        city_list = os.path.join(filelist_root, "cityscapes", f"cityscapes_semantic_{mode}.txt")
        city_root = root.replace("city_lost", "cityscapes")
        if os.path.isfile(city_list):
            for line in read_text_lines(city_list):
                parts = line.split()
                self.samples.append({
                    "left": os.path.join(city_root, parts[0]),
                    "left_name": parts[0].split("/", 1)[-1],
                    "frame_name": os.path.basename(parts[0]),
                    "label": os.path.join(city_root, parts[3]) if len(parts) > 3 else None,
                    "kind": "cityscapes",
                })
