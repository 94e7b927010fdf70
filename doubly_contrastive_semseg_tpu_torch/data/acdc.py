"""ACDC adverse-weather dataset (fog / night / rain / snow) — port of the JAX
package's ``data/acdc.py`` (reference ``dataloaders/datasets/acdc.py:
15-280``), reading the PNGs with ``data/png.py`` instead of PIL.

File-list driven: ``<filelist_root>/acdc/acdc_{train,val,test}[_small].txt``,
one ``rgb_path weather [gt_labelIds_path]`` a line, paths under ``root``;
``debug`` takes the ``_small`` lists where they exist, ``weather_condition``
keeps one weather. Samples hold ``left`` (uint8 (H, W, 3), the frame
converted to RGB), ``label`` (uint8 (H, W) train ids, 255 = ignore),
``weather`` (int array (1,)), ``left_name`` and ``frame_name``: JAX's
sample with numpy arrays where it has PIL images.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .labels import CLASSES, ID_TO_TRAIN_ID, TRAIN_ID_TO_COLOR, WEATHER_DICT
from .png import read_png

WEATHER_DICT_WITH_SUNNY = {**WEATHER_DICT, "sunny": 4}

# label ids 0..33 → train ids, and index 34 (the license plate's row, where
# JAX clamps every id above 33) → 255; uint8 as JAX's CITYSCAPES_ID_TO_TRAIN_ID
CITYSCAPES_ID_TO_TRAIN_ID = ID_TO_TRAIN_ID.astype(np.uint8)

# last wins on duplicate colours, as in JAX (acdc.py:48-54): pole's
# (153, 153, 153) resolves to polegroup's 255; no license-plate row, so
# car's (0, 0, 142) stays 13
COLOR_TO_EVAL_ID = {c.color: c.train_id for c in CLASSES if c.id >= 0}


def read_text_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class ACDC:
    ignore_index = 255
    weather_dict = WEATHER_DICT

    def __init__(self, root: str, mode: str = "train", transform: Optional[Callable] = None,
                 opts=None, filelist_root: str = "filenames"):
        self.root = root
        self.mode = mode
        self.transform = transform
        self.opts = opts
        debug = bool(getattr(opts, "debug", False))
        suffix = "_small" if debug else ""
        list_path = os.path.join(filelist_root, "acdc", f"acdc_{mode}{suffix}.txt")
        if not os.path.isfile(list_path) and debug:
            list_path = os.path.join(filelist_root, "acdc", f"acdc_{mode}.txt")

        weather_condition = getattr(opts, "weather_condition", None)
        self.samples: List[Dict] = []
        for line in read_text_lines(list_path):
            parts = line.split()
            left_img, gt_weather = parts[0], parts[1]
            gt_label = parts[2] if len(parts) > 2 else None
            if weather_condition is not None and gt_weather != weather_condition:
                continue
            self.samples.append({
                "left": os.path.join(root, left_img),
                "left_name": left_img.split("/", 1)[-1],
                "frame_name": os.path.basename(left_img).replace("_rgb_anon", "*"),
                "weather": self.weather_dict[gt_weather],
                "label": os.path.join(root, gt_label) if gt_label else None,
            })

    @classmethod
    def encode_target(cls, target) -> np.ndarray:
        """gt labelIds → train ids (reference ``acdc.py:166-168``)."""
        arr = np.asarray(target).astype(np.uint8)
        arr = np.minimum(arr, len(CITYSCAPES_ID_TO_TRAIN_ID) - 1)
        return CITYSCAPES_ID_TO_TRAIN_ID[arr]

    @classmethod
    def decode_target(cls, target) -> np.ndarray:
        """Train ids → RGB (reference ``acdc.py:170-174``)."""
        target = np.array(target).copy()
        target[target == 255] = 19
        return TRAIN_ID_TO_COLOR[target]

    @classmethod
    def convert_color_to_eval_id(cls, pixel_rgb) -> int:
        tid = COLOR_TO_EVAL_ID[tuple(pixel_rgb)]
        return 255 if tid == 19 else tid

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        rec = self.samples[index]
        sample: Dict = {
            "left": read_png(rec["left"], mode="RGB"),
            "left_name": rec["left_name"],
            "frame_name": rec["frame_name"],
            "weather": np.array([rec["weather"]]),
        }
        if rec["label"] is not None:
            sample["label"] = self.encode_target(read_png(rec["label"]))
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
