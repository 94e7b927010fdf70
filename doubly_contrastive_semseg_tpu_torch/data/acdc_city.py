"""ACDC with the Cityscapes frames as a fifth weather — port of the JAX
package's ``data/acdc_city.py`` (reference ``dataloaders/datasets/
acdc_city.py:15-206``): the adverse-weather ACDC frames of
``<filelist_root>/acdc/acdc_{mode}.txt`` under ``root`` with "acdc_city"
replaced by "acdc", then, where the list exists, the clear-weather
Cityscapes frames of ``<filelist_root>/cityscapes/cityscapes_semantic_
{mode}.txt`` under ``root`` with "acdc_city" replaced by "cityscapes",
labelled weather ``sunny`` = 4 (so ``--weather_num 5``). Samples are
``ACDC``'s: ``left``, ``label``, ``weather`` (int array (1,)),
``left_name``, ``frame_name``; the Cityscapes right frames are not read.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .acdc import ACDC, WEATHER_DICT_WITH_SUNNY, read_text_lines
from .images import read_image


class ACDC_City:
    ignore_index = 255
    weather_dict = WEATHER_DICT_WITH_SUNNY
    encode_target = ACDC.encode_target
    decode_target = ACDC.decode_target
    convert_color_to_eval_id = ACDC.convert_color_to_eval_id

    def __init__(self, root: str, dataset_name: str = "acdc_city", mode: str = "train",
                 transform: Optional[Callable] = None, opts=None,
                 filelist_root: str = "filenames"):
        self.root = root
        self.transform = transform
        self.opts = opts
        self.samples: List[Dict] = []

        acdc_root = root.replace("acdc_city", "acdc")
        city_root = root.replace("acdc_city", "cityscapes")

        for line in read_text_lines(os.path.join(filelist_root, "acdc", f"acdc_{mode}.txt")):
            parts = line.split()
            self.samples.append({
                "left": os.path.join(acdc_root, parts[0]),
                "left_name": parts[0].split("/", 1)[-1],
                "frame_name": os.path.basename(parts[0]).replace("_rgb_anon", "*"),
                "weather": self.weather_dict[parts[1]],
                "label": os.path.join(acdc_root, parts[2]) if len(parts) > 2 else None,
            })

        city_list = os.path.join(filelist_root, "cityscapes", f"cityscapes_semantic_{mode}.txt")
        if os.path.isfile(city_list):
            for line in read_text_lines(city_list):
                parts = line.split()
                label = parts[3] if len(parts) > 3 else None
                self.samples.append({
                    "left": os.path.join(city_root, parts[0]),
                    "left_name": parts[0].split("/", 1)[-1],
                    "frame_name": os.path.basename(parts[0]),
                    "weather": self.weather_dict["sunny"],
                    "label": os.path.join(city_root, label) if label else None,
                })

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        rec = self.samples[index]
        sample: Dict = {
            "left": read_image(rec["left"]),
            "left_name": rec["left_name"],
            "frame_name": rec["frame_name"],
            "weather": np.array([rec["weather"]]),
        }
        if rec["label"] is not None:
            sample["label"] = self.encode_target(read_image(rec["label"], mode=None))
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
