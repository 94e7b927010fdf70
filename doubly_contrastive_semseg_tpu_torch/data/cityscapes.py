"""Cityscapes on the semantic route — port of the JAX package's
``data/cityscapes.py`` (reference ``dataloaders/datasets/cityscapes.py:
15-217``), reading the frames with ``data/images.py`` instead of PIL.

File-list driven: ``<filelist_root>/cityscapes/cityscapes_semantic_{mode}
.txt``, one ``left right [disparity] [gt_labelIds]`` a line, paths under
``root``. Samples hold ``left`` (uint8 (H, W, 3)), ``right`` where its file
exists (uint8 (H, W, 3), on the semantic route too, as in JAX: the val
resize and the host crops leave it whole), ``label`` (uint8 (H, W) train
ids through ``ACDC.encode_target``: ids above 33 clamp to the ignore id),
``left_name`` and ``frame_name``; no ``weather``.

The disparity column, JAX's ``read_disp`` and the lists of ``kitti_2015``,
``kitti_mix`` and ``sceneflow`` belong to stereo training (``ROADMAP.md``
§1 item 5c): ``load_disp`` is false for ``cityscapes``, as in JAX, and
asking for the disparity (another dataset name, or ``load_disp=True``)
raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from .acdc import ACDC, read_text_lines
from .images import read_image


class Cityscapes:
    ignore_index = 255
    weather_dict = {"sunny": 4}
    encode_target = ACDC.encode_target
    decode_target = ACDC.decode_target
    convert_color_to_eval_id = ACDC.convert_color_to_eval_id

    def __init__(self, root: str, dataset_name: str = "cityscapes", mode: str = "train",
                 transform: Optional[Callable] = None, opts=None,
                 filelist_root: str = "filenames", load_disp: Optional[bool] = None):
        self.root = root
        self.mode = mode
        self.transform = transform
        self.dataset_name = dataset_name
        self.opts = opts
        self.load_disp = (dataset_name != "cityscapes") if load_disp is None else load_disp
        if self.load_disp:
            raise NotImplementedError(
                "not ported yet: the disparity maps of stereo training are ROADMAP.md §1 "
                f"item 5c (dataset {dataset_name!r})")
        list_path = os.path.join(filelist_root, "cityscapes", f"cityscapes_semantic_{mode}.txt")

        self.samples: List[Dict] = []
        for line in read_text_lines(list_path):
            parts = line.split()
            left_img, right_img = parts[:2]
            gt_disp = parts[2] if len(parts) > 2 else None
            gt_label = parts[3] if len(parts) > 3 else None
            self.samples.append({
                "left": os.path.join(root, left_img),
                "right": os.path.join(root, right_img),
                "left_name": left_img.split("/", 1)[-1],
                "frame_name": os.path.basename(left_img),
                "disp": os.path.join(root, gt_disp) if gt_disp else None,
                "label": os.path.join(root, gt_label) if gt_label else None,
            })

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        rec = self.samples[index]
        sample: Dict = {
            "left": read_image(rec["left"]),
            "left_name": rec["left_name"],
            "frame_name": rec["frame_name"],
        }
        if rec["right"] is not None and os.path.exists(rec["right"]):
            sample["right"] = read_image(rec["right"])
        if rec["label"] is not None:
            sample["label"] = self.encode_target(read_image(rec["label"], mode=None))
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
