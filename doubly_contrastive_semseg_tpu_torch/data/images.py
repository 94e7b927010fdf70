"""The port's one image reader: PNG through ``data/png.py``, anything else
(JPEG above all) through PIL, as the JAX package reads every image
(``Image.open(path).convert("RGB")``).

PIL is imported inside the call, so the PNG routes never need it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .png import read_png


def read_image(path, mode: Optional[str] = "RGB") -> np.ndarray:
    """The pixels of the image at ``path`` as uint8: a ``.png`` through
    ``read_png(path, mode)``, any other file through
    ``PIL.Image.open(path)``, converted with ``.convert(mode)`` where
    ``mode`` is given (``np.array(Image.open(path))`` where it is None)."""
    path = os.fspath(path)
    if path.lower().endswith(".png"):
        return read_png(path, mode=mode)
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError as e:
        raise ImportError(f"{path}: reading a file that is not a PNG needs PIL "
                          f"(Pillow), which does not import here: {e}") from e
    try:
        with Image.open(path) as im:
            return np.array(im.convert(mode) if mode else im)
    except UnidentifiedImageError as e:
        raise ValueError(f"{path}: PIL cannot identify this file as an image") from e
