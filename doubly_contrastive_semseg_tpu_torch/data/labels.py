"""Structured Cityscapes label table — a copy of the JAX package's
``data/labels.py`` (reference ``dataloaders/datasets/cityscapes_labels.py:
7-72``), plus the constants the synthetic dataset takes from the JAX
package's ``data/acdc.py`` (``WEATHER_DICT``, ``acdc.py:19``, and the uint8
``TRAIN_ID_TO_COLOR``, ``acdc.py:42``, whose values are those of the table
below), without that module's file-backed dataset and its PIL import.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

CityscapesClass = namedtuple(
    "CityscapesClass",
    ["name", "id", "train_id", "category", "category_id",
     "has_instances", "ignore_in_eval", "color"])

# the public cityscapesScripts table (https://github.com/mcordts/cityscapesScripts)
CLASSES = (
    CityscapesClass("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    CityscapesClass("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    CityscapesClass("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    CityscapesClass("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    CityscapesClass("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    CityscapesClass("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    CityscapesClass("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    CityscapesClass("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    CityscapesClass("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    CityscapesClass("guard rail", 14, 255, "construction", 2, False, True, (180, 165, 180)),
    CityscapesClass("bridge", 15, 255, "construction", 2, False, True, (150, 100, 100)),
    CityscapesClass("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    CityscapesClass("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    CityscapesClass("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    CityscapesClass("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    CityscapesClass("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    CityscapesClass("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    CityscapesClass("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    CityscapesClass("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    CityscapesClass("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    CityscapesClass("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    CityscapesClass("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    CityscapesClass("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    CityscapesClass("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    CityscapesClass("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    CityscapesClass("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    CityscapesClass("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    CityscapesClass("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    CityscapesClass("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    CityscapesClass("license plate", -1, 255, "vehicle", 7, False, True, (0, 0, 142)),
)

# all 35 rows incl. the id=-1 license plate, so index -1 resolves to it —
# matching the reference table's wrap-around behavior
ID_TO_TRAIN_ID = np.array([c.train_id for c in CLASSES])
# 19 classes + black for ignore/void; uint8 as in JAX acdc.py:42
TRAIN_ID_TO_COLOR = np.array(
    [c.color for c in CLASSES if c.train_id not in (-1, 255)] + [(0, 0, 0)],
    dtype=np.uint8)
WEATHER_DICT = {"fog": 0, "night": 1, "rain": 2, "snow": 3}

TRAIN_ID_TO_NAME = tuple(
    c.name for c in CLASSES if c.train_id not in (-1, 255))


def encode_target(target) -> np.ndarray:
    """Raw label ids → train ids (255 = ignore). Signed indexing so id=-1
    wraps to the license-plate row exactly like the reference's table."""
    return ID_TO_TRAIN_ID[np.asarray(target, np.int64)]


def decode_target(target) -> np.ndarray:
    """Train ids → RGB; ignore renders black."""
    t = np.asarray(target).copy()
    t[t == 255] = 19
    return TRAIN_ID_TO_COLOR[t]
