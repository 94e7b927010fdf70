"""Host-side sample transforms of the loader-fed paths — the part of the
JAX package's ``data/transforms.py`` that the on-device augmentation route
(``host_augment=False``) and the val split need: ``Compose``,
``ThreadSafeRng``, ``SetTargetSize``, ``ToArrays`` and ``FixedResize``.

Samples hold numpy arrays where JAX's hold PIL images (the card's machine
has no PIL), so ``FixedResize`` carries a numpy copy of Pillow's resampling
(``src/libImaging/Resample.c`` and ``Geometry.c``): the bilinear image
resize in Pillow's 8-bit fixed point and the nearest label resize, both bit
for bit Pillow's. The random train transforms are not ported yet
(``ROADMAP.md`` §1 item 1b).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence, Tuple

import numpy as np


class ThreadSafeRng:
    """Lock-protected ``np.random.Generator`` proxy: the threaded loader
    runs ``dataset.__getitem__`` on several workers at once, and racing
    draws would corrupt the generator's state. Which sample gets which draw
    still depends on the workers' scheduling."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._lock = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._rng, name)
        if not callable(attr):
            return attr

        def locked(*args, **kwargs):
            with self._lock:
                return attr(*args, **kwargs)

        return locked


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


# ---- Pillow's resampling in numpy -------------------------------------------

_PRECISION_BITS = 32 - 8 - 2   # Resample.c: 8-bit samples, 22 fraction bits


def _bilinear_coeffs(in_size: int, out_size: int):
    """Resample.c ``precompute_coeffs`` with the triangle filter (support 1,
    scaled by the downscale factor) and ``normalize_coeffs_8bpc``: each
    output's first tap and tap count, and its fixed-point weights
    (out_size, ksize), normalised in double in Pillow's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize))
    total = np.zeros(out_size)
    for x in range(ksize):            # Pillow sums the taps in this order
        t = np.abs((x + xmin - center + 0.5) * ss)
        w = np.where((t < 1.0) & (x < xmax), 1.0 - t, 0.0)
        k[:, x] = w
        total = total + w
    k = np.where(total[:, None] != 0.0, k / np.where(total == 0.0, 1.0, total)[:, None], k)
    one = 1 << _PRECISION_BITS
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int64)
    return xmin, xmax, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Resample.c's ``ImagingResample{Horizontal,Vertical}_8bpc``
    along ``axis`` of a uint8 array: integer sums from half a unit,
    shifted down and clipped to uint8."""
    in_size = img.shape[axis]
    xmin, xmax, kk = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    bshape = (-1,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        w = np.where(x < xmax, kk[:, x], 0)
        acc += src[idx].astype(np.int64) * w.reshape(bshape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.BILINEAR)`` of a uint8 (H, W) or (H, W, C)
    array, ``size`` (w, h): the horizontal pass, then the vertical, each
    only where that side changes; the same size returns a copy."""
    w, h = size
    out = np.asarray(img)
    if out.dtype != np.uint8:
        raise TypeError(f"resize_bilinear_pil: a uint8 image, got {out.dtype}")
    if w != out.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.array(out)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c ``ImagingScaleAffine``: the source coordinate starts at
    half a step and is advanced by one step per output pixel, summed in
    double in that order, then truncated (negative: out of frame)."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.where(pos < 0.0, -1, np.trunc(pos)).astype(np.int64)


def resize_nearest_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.NEAREST)`` of an (H, W, ...) array,
    ``size`` (w, h)."""
    w, h = size
    img = np.asarray(img)
    ys = _nearest_index(img.shape[0], h)
    xs = _nearest_index(img.shape[1], w)
    return img[ys][:, xs]


class FixedResize:
    """Deterministic val resize: bilinear image, nearest label (reference
    ``custom_transforms_acdc.py:579-594``), bit for bit Pillow's.
    ``size`` is (w, h)."""

    def __init__(self, size: Tuple[int, int]):
        self.size = tuple(size)

    def __call__(self, sample: Dict) -> Dict:
        if sample.get("label") is not None:
            sample["label"] = resize_nearest_pil(sample["label"], self.size)
        sample["left"] = resize_bilinear_pil(sample["left"], self.size)
        return sample


class SetTargetSize:
    """Attach (h, w) target metadata (reference
    ``custom_transforms_acdc.py:597-613``)."""

    def __init__(self, target_size, target_size_feats, stride: int = 4):
        self.target_size = target_size
        self.target_size_feats = target_size_feats
        self.stride = stride

    def __call__(self, sample: Dict) -> Dict:
        sample["target_size"] = self.target_size[::-1]
        sample["target_size_feats"] = self.target_size_feats[::-1]
        sample["alphas"] = [-1]
        sample["target_level"] = 0
        return sample


def _wire_image(img) -> np.ndarray:
    """The narrowest exact wire type of an image: uint8 stays, anything
    else becomes float32."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    return arr.astype(np.float32)


class ToArrays:
    """Sample → the loader's wire types (JAX ``ToArrays``): uint8 (or
    float32) HWC images on the 0-255 scale, uint8 labels (255 = ignore;
    other integer labels become int32), float32 disparity, int32 scalar
    weather. The steps widen them on the device (``train/steps.py::
    ingest_batch``)."""

    def __call__(self, sample: Dict) -> Dict:
        out = dict(sample)
        out["left"] = _wire_image(sample["left"])
        if sample.get("right") is not None:
            out["right"] = _wire_image(sample["right"])
        if sample.get("disp") is not None:
            out["disp"] = np.asarray(sample["disp"], np.float32)
        if sample.get("label") is not None:
            lbl = np.asarray(sample["label"])
            out["label"] = lbl if lbl.dtype == np.uint8 else lbl.astype(np.int32)
        if "weather" in sample and sample["weather"] is not None:
            out["weather"] = np.asarray(sample["weather"], np.int32).reshape(())
        return out
