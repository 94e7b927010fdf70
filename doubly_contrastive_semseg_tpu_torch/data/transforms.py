"""Host-side sample transforms of the loader-fed paths — the part of the
JAX package's ``data/transforms.py`` that the train and val pipelines of
``data/factory.py`` use: ``Compose``, ``ThreadSafeRng``, ``ReferenceRng``,
``TwoCropTransform``, ``RandomSquareCropAndScale``, ``SetTargetSize``,
``LabelBoundaryTransform``, ``GammaCorrection``, ``FixedResize`` and
``ToArrays``.

Samples hold numpy arrays where JAX's hold PIL images (the card's machine
has neither PIL nor cv2), so this module carries numpy copies of what JAX
calls there, each bit for bit the library's:

- Pillow's resampling (``src/libImaging/Resample.c`` and ``Geometry.c``):
  bilinear and bicubic in Pillow's 8-bit fixed point, one resampler with
  the filter as a parameter, and the nearest resize;
- Pillow's ``Image.new`` + ``paste`` + ``crop`` as array slicing;
- cv2's 3×3 chamfer distance transform (``data/chamfer.py``).

``CropBlackArea``, ``ColorJitter``, the flips, ``RandomResizedCrop``,
``RandomAffine`` and ``RandomErasing`` are not ported: only the
``city_lost`` pipeline uses them (``ROADMAP.md`` §1 item 1c).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence, Tuple

import numpy as np

from .chamfer import label_chamfer_distance


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


class ReferenceRng:
    """The legacy ``np.random`` stream of the reference program (JAX
    ``ReferenceRng``): its train transforms draw from the global
    ``np.random`` (``np.random.uniform``, then two ``np.random.randint``),
    seeded once, so ``RandomState(seed)`` gives a single-worker, unshuffled
    run the reference's crop boxes and scales, draw for draw. Maps the
    ``np.random.Generator`` methods the transforms call onto RandomState's."""

    def __init__(self, seed: int):
        self._rs = np.random.RandomState(seed)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._rs.uniform(low, high, size)

    def integers(self, low, high=None, size=None):
        return self._rs.randint(low, high, size)

    def random(self, size=None):
        return self._rs.random_sample(size)

    def permutation(self, x):
        return self._rs.permutation(x)

    def get_state(self):
        return self._rs.get_state()

    def set_state(self, state) -> None:
        self._rs.set_state(state)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class TwoCropTransform:
    """Run the whole pipeline twice a sample, for the two contrastive views
    (reference ``dataloaders/utils.py:13-22``)."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, sample: Dict):
        return [self.transform(dict(sample)), self.transform(dict(sample))]


def iter_transform_rngs(transform):
    """Yield every rng with ``get_state``/``set_state`` reachable from a
    pipeline (``Compose``, ``TwoCropTransform``, transforms with an ``rng``),
    so a caller can restore the augmentation streams after drawing a sample
    it does not train on."""
    if transform is None:
        return
    stack = [transform]
    seen = set()
    while stack:
        t = stack.pop()
        if id(t) in seen:
            continue
        seen.add(id(t))
        if isinstance(t, Compose):
            stack.extend(t.transforms)
        elif isinstance(t, TwoCropTransform):
            stack.append(t.transform)
        rng = getattr(t, "rng", None)
        if rng is not None and hasattr(rng, "get_state") and hasattr(rng, "set_state"):
            yield rng


# ---- Pillow's resampling in numpy -------------------------------------------

_PRECISION_BITS = 32 - 8 - 2   # Resample.c: 8-bit samples, 22 fraction bits


def _bilinear_filter(t: np.ndarray) -> np.ndarray:
    """Resample.c ``bilinear_filter`` of |x| (support 1)."""
    return np.where(t < 1.0, 1.0 - t, 0.0)


def _bicubic_filter(t: np.ndarray) -> np.ndarray:
    """Resample.c ``bicubic_filter`` of |x| (a = −0.5, support 2), in its
    order of operations."""
    a = -0.5
    return np.where(t < 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1,
                    np.where(t < 2.0, (((t - 5) * t + 8) * t - 4) * a, 0.0))


_FILTERS = {"bilinear": (_bilinear_filter, 1.0), "bicubic": (_bicubic_filter, 2.0)}


def _pil_coeffs(in_size: int, out_size: int, filt, support: float, span=None):
    """Resample.c ``precompute_coeffs`` (the filter's support scaled by the
    downscale factor) and ``normalize_coeffs_8bpc``: each output's first
    tap and its int32 fixed-point weights (out_size, ksize), normalised in
    double in Pillow's order, 0 past the output's tap count. ``span`` is
    the source interval (in0, in1) of a resize box, float32 as Pillow
    parses it; None is the whole axis."""
    in0, in1 = (0.0, float(in_size)) if span is None else map(np.float32, span)
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize))
    total = np.zeros(out_size)
    for x in range(ksize):            # Pillow sums the taps in this order
        t = np.abs((x + xmin - center + 0.5) * ss)
        w = np.where(x < xmax, filt(t), 0.0)
        k[:, x] = w
        total = total + w
    k = np.where(total[:, None] != 0.0, k / np.where(total == 0.0, 1.0, total)[:, None], k)
    one = 1 << _PRECISION_BITS
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int32)
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str,
                   span=None) -> np.ndarray:
    """One pass of Resample.c's ``ImagingResample{Horizontal,Vertical}_8bpc``
    along ``axis`` of a uint8 array (over ``span`` of it, see
    ``_pil_coeffs``): int32 sums from half a unit, shifted down and clipped
    to uint8. The pass runs on a contiguous (in_size, -1) copy, so each tap
    gathers whole rows."""
    in_size = img.shape[axis]
    xmin, kk = _pil_coeffs(in_size, out_size, *_FILTERS[kind], span=span)
    src = np.moveaxis(img, axis, 0)
    rest = src.shape[1:]
    src = np.ascontiguousarray(src).reshape(in_size, -1)
    acc = np.full((out_size, src.shape[1]), 1 << (_PRECISION_BITS - 1), np.int32)
    prod = np.empty_like(acc)
    for x in range(kk.shape[1]):      # taps past an output's count weigh 0
        np.multiply(src[np.minimum(xmin + x, in_size - 1)], kk[:, x:x + 1], out=prod)
        acc += prod
    acc >>= _PRECISION_BITS
    out = np.clip(acc, 0, 255).astype(np.uint8).reshape((out_size,) + rest)
    return np.moveaxis(out, 0, axis)


def _resize_pil(img: np.ndarray, size: Tuple[int, int], kind: str, box=None) -> np.ndarray:
    """``Image.resize(size, BILINEAR or BICUBIC)`` of a uint8 (H, W) or
    (H, W, C) array, ``size`` (w, h): the horizontal pass, then the
    vertical, each only where that side changes; the same size returns a
    copy. ``box`` (x0, y0, x1, y1) is the ``im.resize`` box of the source
    region (``ImagingResampleInner``: a pass wherever the box is not the
    output's extent)."""
    w, h = size
    out = np.asarray(img)
    if out.dtype != np.uint8:
        raise TypeError(f"resize_{kind}_pil: a uint8 image, got {out.dtype}")
    if box is None:
        if w != out.shape[1]:
            out = _resample_axis(out, w, 1, kind)
        if h != out.shape[0]:
            out = _resample_axis(out, h, 0, kind)
        return np.array(out)
    x0, y0, x1, y1 = (float(np.float32(v)) for v in box)
    if w != out.shape[1] or x0 != 0 or x1 != w:
        out = _resample_axis(out, w, 1, kind, span=(x0, x1))
    if h != out.shape[0] or y0 != 0 or y1 != h:
        out = _resample_axis(out, h, 0, kind, span=(y0, y1))
    return np.array(out)


def resize_bilinear_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.BILINEAR)`` of a uint8 array, bit for bit."""
    return _resize_pil(img, size, "bilinear")


def resize_bicubic_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size, Image.BICUBIC)`` of a uint8 array, bit for bit."""
    return _resize_pil(img, size, "bicubic")


def reduce_pil(img: np.ndarray, factor: Tuple[int, int], box=None) -> np.ndarray:
    """``Image.reduce(factor, box)`` of a uint8 (H, W) or (H, W, C) array
    (``src/libImaging/Reduce.c``): each output pixel is the mean of its
    factor_x × factor_y block of ``box`` (x0, y0, x1, y1), the blocks of
    the last row and column cut by the box, as ``((sum + n // 2) · m) >>
    24`` with n the block's pixel count and m = ⌊2³² / (256 n)⌋ divided in
    float32 (``division_UINT32``)."""
    fx, fy = factor
    img = np.asarray(img)
    x0, y0, x1, y1 = box if box is not None else (0, 0, img.shape[1], img.shape[0])
    region = img[y0:y1, x0:x1].astype(np.uint64)
    h, w = region.shape[:2]
    oh, ow = -(-h // fy), -(-w // fx)
    padded = np.zeros((oh * fy, ow * fx) + region.shape[2:], np.uint64)
    padded[:h, :w] = region
    sums = padded.reshape((oh, fy, ow, fx) + region.shape[2:]).sum(axis=(1, 3))
    ny = np.minimum(fy, h - fy * np.arange(oh))
    nx = np.minimum(fx, w - fx * np.arange(ow))
    n = (ny[:, None] * nx[None, :]).astype(np.uint64)
    m = (np.float32(4294967296.0) / (n * 256).astype(np.float32)).astype(np.uint64)
    if sums.ndim == 3:
        n, m = n[..., None], m[..., None]
    return (((sums + n // 2) * m) >> 24).astype(np.uint8)


def thumbnail_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.thumbnail(size)`` of a uint8 (H, W) or (H, W, 3) array, as a
    new array: the largest size within ``size`` that keeps the aspect
    (Pillow's rounding), reached by ``reduce`` with the factor that leaves
    at least twice the target (``reducing_gap`` 2.0) over the box that the
    bicubic filter reads (``_get_safe_box``), then the bicubic resize of
    the reduced box."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    x, y = (math.floor(v) for v in size)
    if x >= w and y >= h:
        return img.copy()

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    if (x, y) == (w, h):
        return img.copy()
    box = (0, 0, w, h)
    fx, fy = int(w / x / 2.0) or 1, int(h / y / 2.0) or 1
    if fx > 1 or fy > 1:
        support = 2.0 - 0.5                  # bicubic's support less half a pixel
        sx, sy = support * w / x, support * h / y
        rb = (max(0, int(0 - sx)), max(0, int(0 - sy)),
              min(w, math.ceil(w + sx)), min(h, math.ceil(h + sy)))
        img = reduce_pil(img, (fx, fy), rb)
        box = ((0 - rb[0]) / fx, (0 - rb[1]) / fy, (w - rb[0]) / fx, (h - rb[1]) / fy)
    return _resize_pil(img, (x, y), "bicubic", box)


def blend_pil(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(a, b, alpha)`` of two uint8 arrays of one shape, for
    ``alpha`` in [0, 1] (``ImagingBlend``): a + alpha · (b − a) in float32,
    truncated to uint8."""
    a, b = np.asarray(a), np.asarray(b)
    diff = (b.astype(np.int32) - a.astype(np.int32)).astype(np.float32)
    return (a.astype(np.float32) + np.float32(alpha) * diff).astype(np.uint8)


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


def _crop_and_scale_img(img: np.ndarray, crop_box, target_size, resize,
                        blank_value) -> np.ndarray:
    """JAX ``_crop_and_scale_img`` (reference ``custom_transforms_acdc.py:
    530-535``): ``Image.new(pad_size, blank_value)``, ``paste`` the image at
    the origin, ``crop(crop_box)``, ``resize(target_size)``. Only the box
    is built: the blank value, with the image's overlap copied in."""
    x0, y0, x1, y1 = crop_box          # inside the padded canvas
    h, w = img.shape[:2]
    box = np.empty((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    box[...] = np.asarray(blank_value, img.dtype)
    ih, iw = max(0, min(y1, h) - y0), max(0, min(x1, w) - x0)
    box[:ih, :iw] = img[y0:y0 + ih, x0:x0 + iw]
    return resize(box, target_size)


class RandomSquareCropAndScale:
    """A box of ``scale · wh``, scale ~ U(min, max), at a random place on the
    frame padded with the dataset mean (labels: the ignore id), resized to
    ``wh``: bicubic image, nearest label (reference
    ``custom_transforms_acdc.py:444-525``). The draws are JAX's, in JAX's
    order, from ``rng``: ``uniform``, then two ``integers``."""

    def __init__(self, wh: Tuple[int, int], mean: Tuple[int, int, int],
                 ignore_id: int = 255, min: float = 0.5, max: float = 2.0, rng=None):
        self.wh = wh
        self.mean = tuple(int(m) for m in mean)
        self.ignore_id = ignore_id
        self.min = min
        self.max = max
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        left = np.asarray(sample["left"])
        scale = float(self.rng.uniform(self.min, self.max))
        h_img, w_img = left.shape[:2]
        box_w = int(scale * self.wh[0])
        box_h = int(scale * self.wh[1])
        pad_size = (max(box_w, w_img), max(box_h, h_img))
        try:
            x0 = int(self.rng.integers(0, pad_size[0] - box_w + 1))
            y0 = int(self.rng.integers(0, pad_size[1] - box_h + 1))
        except ValueError:
            x0 = y0 = 0
        crop_box = (x0, y0, x0 + box_w, y0 + box_h)
        target_size = (self.wh[0], self.wh[1])

        out = dict(sample)
        out["left"] = _crop_and_scale_img(left, crop_box, target_size, resize_bicubic_pil,
                                          self.mean)
        if "label" in sample and sample["label"] is not None:
            out["label"] = _crop_and_scale_img(np.asarray(sample["label"]), crop_box,
                                               target_size, resize_nearest_pil, self.ignore_id)
        return out


class LabelBoundaryTransform:
    """Each class's 3×3 chamfer distance to its boundary (cv2's ``DIST_L2``,
    mask 3, ``data/chamfer.py``), summed over the classes, → the boundary
    weight exp(−d / 2σ), zero at ignore pixels (reference
    ``custom_transforms_acdc.py:656-693``): the ``alphas`` of the
    boundary-aware focal loss. ``reduce=False`` keeps the (C, H, W)
    distances, −1 off each class's pixels. σ, the guard and the exponent are
    JAX's float32 numpy calls on the same array.

    A map of one label has no boundary. There cv2's default route (IPP, in
    the x86 ``opencv-python`` wheels) gives every pixel FLT_MAX, where the
    fixed-point chamfer gives 65534.63; JAX's σ then overflows to inf and
    every weight is exp(−0) = 1, not exp(−32767) = 0. A 768² crop of one
    class (all road, all sky) can be drawn at box scale 0.5, so this case
    takes the default route's distances."""

    def __init__(self, num_classes: int, reduce: bool = True, ignore_id: int = 255):
        self.num_classes = num_classes
        self.reduce = reduce
        self.ignore_id = ignore_id

    def __call__(self, sample: Dict) -> Dict:
        labels = np.asarray(sample["label"])
        if labels.size and (labels == labels.flat[0]).all():
            dist = np.full(labels.shape, np.finfo(np.float32).max, np.float32)
        else:
            dist = label_chamfer_distance(labels)
        in_class = labels < self.num_classes
        if self.reduce:
            # one class holds a pixel, so JAX's sum over the classes is the
            # pixel's own distance (exactly: the other terms are 0)
            summed = np.where(in_class, dist, np.float32(0.0))
            with np.errstate(over="ignore"):     # FLT_MAX everywhere: σ = inf
                std = np.std(summed)
            if std == 0:  # all-ignore images (reference :681-684)
                std = 1.0
            weights = np.exp(-summed / (2.0 * std))
            weights[labels == self.ignore_id] = 0.0
            sample["label_distance_weight"] = weights.astype(np.float32)
        else:
            distances = np.full((self.num_classes,) + labels.shape, -1.0, np.float32)
            ys, xs = np.nonzero(in_class)
            distances[labels[ys, xs].astype(np.int64), ys, xs] = dist[ys, xs]
            sample["label_distance_transform"] = distances
        return sample


class GammaCorrection:
    """The γ = 0.4 lookup table on night frames only (weather id 1;
    reference ``custom_transforms_acdc.py:695-711``)."""

    def __init__(self, gamma: float = 0.4):
        self.gamma = gamma
        x = np.arange(256, dtype=np.float64)
        self.lut = np.clip((x / 255.0) ** gamma * 255.0, 0, 255).astype(np.uint8)

    def __call__(self, sample: Dict) -> Dict:
        weather = sample.get("weather")
        if weather is not None and int(np.asarray(weather).reshape(-1)[0]) == 1:
            sample["left"] = self.lut[np.asarray(sample["left"])]
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
