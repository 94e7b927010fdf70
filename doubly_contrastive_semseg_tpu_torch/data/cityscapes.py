"""Cityscapes and the stereo lists — port of the JAX package's
``data/cityscapes.py`` (reference ``dataloaders/datasets/cityscapes.py:
15-217``, ``utils/file_io.py:18-37``), reading the frames with
``data/images.py`` instead of PIL.

File-list driven: ``<filelist_root>/<LIST_FILES entry>`` (``cityscapes``,
``kitti_2015``, ``kitti_mix``, ``sceneflow``), one ``left right
[disparity] [gt_labelIds]`` a line, paths under ``root``. Samples hold
``left`` (uint8 (H, W, 3)), ``right`` where its file exists (uint8 (H, W,
3), on the semantic route too, as in JAX), ``disp`` (float32 (H, W),
``read_disp``) where the list has the column and ``load_disp`` is true,
``label`` (uint8 (H, W) train ids through ``ACDC.encode_target``: ids above
33 clamp to the ignore id), ``left_name`` and ``frame_name``; no
``weather``. ``load_disp`` defaults to false for ``cityscapes`` (the
semantic route never reads it) and true for the stereo lists, as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from .acdc import ACDC, read_text_lines
from .images import read_image
from .png import read_png

LIST_FILES = {
    "cityscapes": "cityscapes/cityscapes_semantic_{mode}.txt",
    "kitti_2015": "kitti_2015/KITTI_2015_{mode}.txt",
    "kitti_mix": "kitti_mix/KITTI_MIX_{mode}.txt",
    "sceneflow": "sceneflow/SceneFlow_finalpass_{mode}.txt",
}


def read_disp(path: str) -> np.ndarray:
    """A disparity map as float32 (JAX ``read_disp``): ``.pfm`` (SceneFlow)
    through ``_read_pfm``, ``.png`` as v / 256 for every PNG (KITTI's 16-bit
    encoding; JAX applies it to Cityscapes' PNGs too, whose own encoding is
    (v − 1) / 256, and the port keeps that), ``.npy`` as stored."""
    if path.endswith(".pfm"):
        return _read_pfm(path)
    if path.endswith(".png"):
        return read_png(path).astype(np.float32) / 256.0
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    raise ValueError(f"invalid disparity file: {path}")


def _read_pfm(path: str) -> np.ndarray:
    """A PFM file: header ``PF`` (3 channels) or ``Pf`` (grey), width and
    height, then the scale, whose sign gives the byte order (negative:
    little-endian); rows are stored bottom to top, so they are flipped."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        if header not in ("PF", "Pf"):
            raise ValueError("not a PFM file")
        dims = f.readline().decode("ascii").split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode("ascii").strip())
        data = np.frombuffer(f.read(), dtype="<f" if scale < 0 else ">f")
        shape = (height, width, 3) if header == "PF" else (height, width)
        return np.flipud(data.reshape(shape)).astype(np.float32).copy()


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
        list_path = os.path.join(filelist_root, LIST_FILES[dataset_name].format(mode=mode))

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
        if rec["disp"] is not None and self.load_disp:
            sample["disp"] = read_disp(rec["disp"])
        if rec["label"] is not None:
            sample["label"] = self.encode_target(read_image(rec["label"], mode=None))
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
