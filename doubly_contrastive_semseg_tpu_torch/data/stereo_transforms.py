"""Stereo-pair transforms — port of the JAX package's
``data/stereo_transforms.py`` (reference ``dataloaders/transforms.py:
9-258``, ``custom_transforms.py:497-590`` ``RandomCrop2``,
``custom_transforms.py:1664-1695`` ``LabelDistanceTransform``).

- ``StereoRandomCrop``: pad-or-crop of both views, the disparity and the
  label to (height, width), one draw for all of them; padding goes on top
  and on the right, zeros for images and disparity, ``label_pad`` for the
  label; ``validate`` takes the centre crop;
- ``StereoRandomVerticalFlip``: both views, disparity and label together;
- the pair photometrics (``RandomContrast``, ``RandomGamma``,
  ``RandomBrightness``, ``RandomHue``, ``RandomSaturation``), each one draw
  for both eyes, on PIL images, and ``RandomColor``, which turns uint8
  arrays into PIL images (``StereoToPIL``), applies one of them or all five
  in a drawn order, and hands back float32 arrays (``StereoToNumpy``);
- ``LabelDistanceTransform``: the binned-α EDT weights of
  ``cv2.distanceTransform`` (L2, mask size 5), which no pipeline calls.

Every draw comes from the ``rng`` given (a ``numpy.random.Generator`` or
``data/transforms.py::ThreadSafeRng``), the same calls in the same order as
JAX's. The photometric adjustments are torchvision's PIL backend
(``data/transforms.py``'s ``adjust_*``); PIL and cv2 are imported inside
the call.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .transforms import (adjust_brightness, adjust_contrast, adjust_gamma, adjust_hue,
                         adjust_saturation)

_EYES = ("left", "right")


class StereoToPIL:
    """Arrays of both views → uint8 PIL images (reference ``transforms.py:
    154-160``)."""

    def __call__(self, sample: Dict) -> Dict:
        from PIL import Image

        for k in _EYES:
            if not isinstance(sample[k], Image.Image):
                sample[k] = Image.fromarray(np.asarray(sample[k]).astype("uint8"))
        return sample


class StereoToNumpy:
    """Both views → float32 arrays (reference ``transforms.py:163-168``)."""

    def __call__(self, sample: Dict) -> Dict:
        for k in _EYES:
            sample[k] = np.array(sample[k]).astype(np.float32)
        return sample


class StereoRandomCrop:
    """Pad-or-crop to (img_height, img_width) over every stereo key. A
    smaller input is padded on top and on the right (images and disparity
    with zeros, the label with ``label_pad``); a larger one takes one random
    crop for all keys (the centre crop when ``validate``). A target larger
    on one axis and smaller on the other raises ``ValueError``, where the
    reference's asserts fire."""

    def __init__(self, img_height: int, img_width: int, validate: bool = False,
                 label_pad: int = 0, rng=None):
        self.img_height = img_height
        self.img_width = img_width
        self.validate = validate
        self.label_pad = label_pad
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        keys_img = [k for k in _EYES if k in sample]
        keys_flat = [k for k in ("disp", "pseudo_disp", "label") if k in sample]
        for k in keys_img + keys_flat:
            sample[k] = np.asarray(sample[k])
        oh, ow = sample["left"].shape[:2]
        if self.img_height > oh or self.img_width > ow:
            tp, rp = self.img_height - oh, self.img_width - ow
            if tp < 0 or rp < 0:
                raise ValueError(
                    f"StereoRandomCrop target ({self.img_height}, {self.img_width}) mixes pad "
                    f"and crop against input ({oh}, {ow}); pad-one-axis/crop-the-other is not "
                    "supported (reference parity)")
            for k in keys_img:
                sample[k] = np.pad(sample[k], ((tp, 0), (0, rp), (0, 0)))
            for k in keys_flat:
                fill = self.label_pad if k == "label" else 0
                sample[k] = np.pad(sample[k], ((tp, 0), (0, rp)), constant_values=fill)
            return sample
        if self.validate:
            ox = (ow - self.img_width) // 2
            oy = (oh - self.img_height) // 2
        else:
            ox = int(self.rng.integers(0, ow - self.img_width + 1))
            oy = int(self.rng.integers(0, oh - self.img_height + 1))
        for k in keys_img + keys_flat:
            sample[k] = sample[k][oy:oy + self.img_height, ox:ox + self.img_width]
        return sample


class StereoRandomVerticalFlip:
    """Both views, disparity and label flipped upside down together with
    probability ``p`` (reference ``transforms.py:136-151``); the disparity's
    values stay."""

    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        if self.rng.random() < self.p:
            for k in ("left", "right", "disp", "label", "pseudo_disp"):
                if k in sample:
                    sample[k] = np.copy(np.flipud(np.asarray(sample[k])))
        return sample


class _PairPhotometric:
    """With probability ``p``, one draw applied to both PIL views
    (reference ``transforms.py:173-231``)."""

    p: float = 0.5
    low, high = 0.0, 0.0
    adjust = None

    def __init__(self, rng=None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        if self.rng.random() < self.p:
            draw = float(self.rng.uniform(self.low, self.high))
            for k in _EYES:
                sample[k] = type(self).adjust(sample[k], draw)
        return sample


class RandomContrast(_PairPhotometric):
    low, high, adjust = 0.8, 1.2, adjust_contrast


class RandomGamma(_PairPhotometric):
    low, high, adjust = 0.7, 1.5, adjust_gamma     # FlowNet's range


class RandomBrightness(_PairPhotometric):
    low, high, adjust = 0.5, 2.0, adjust_brightness


class RandomHue(_PairPhotometric):
    low, high, adjust = -0.1, 0.1, adjust_hue


class RandomSaturation(_PairPhotometric):
    low, high, adjust = 0.8, 1.2, adjust_saturation


class RandomColor:
    """Reference ``transforms.py:234-258``: with probability 0.5 one of the
    five photometrics, drawn by index, else all five in a drawn
    permutation; uint8 arrays in (``StereoToPIL``), float32 arrays out."""

    def __init__(self, rng=None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        transforms = [RandomContrast(self.rng), RandomGamma(self.rng),
                      RandomBrightness(self.rng), RandomHue(self.rng),
                      RandomSaturation(self.rng)]
        sample = StereoToPIL()(sample)
        if self.rng.random() < 0.5:
            sample = transforms[int(self.rng.integers(0, len(transforms)))](sample)
        else:
            for i in self.rng.permutation(len(transforms)):
                sample = transforms[int(i)](sample)
        return StereoToNumpy()(sample)


class LabelDistanceTransform:
    """Binned-α EDT weighting (fork ``custom_transforms.py:1664-1695``): each
    present class's ``cv2.distanceTransform`` (L2, mask size 5) inside its
    mask, −1 elsewhere, as ``label_distance_transform`` (C, H, W); with
    ``reduce`` the distances summed, bucketed by ``bins`` into ``alphas``
    and 0 at ignore, as ``label_distance_alphas`` (H, W)."""

    def __init__(self, num_classes: int, bins: Sequence[int] = (4, 16, 64, 128),
                 alphas: Sequence[float] = (8.0, 6.0, 4.0, 2.0, 1.0),
                 reduce: bool = False, ignore_id: int = 255):
        self.num_classes = num_classes
        self.bins = bins
        self.alphas = alphas
        self.reduce = reduce
        self.ignore_id = ignore_id

    def __call__(self, example: Dict) -> Dict:
        import cv2

        labels = np.array(example["label"])
        present = np.unique(labels)
        distances = np.zeros([self.num_classes] + list(labels.shape), np.float32) - 1.0
        for i in range(self.num_classes):
            if i not in present:
                continue
            mask = labels == i
            distances[i][mask] = cv2.distanceTransform(np.uint8(mask), cv2.DIST_L2,
                                                       maskSize=5)[mask]
        if self.reduce:
            ignore_mask = labels == self.ignore_id
            distances[distances < 0] = 0
            dist = distances.sum(axis=0)
            bins_idx = np.digitize(dist, self.bins)
            alphas = np.zeros(bins_idx.shape, np.float32)
            for idx, a in enumerate(self.alphas):
                alphas[bins_idx == idx] = a
            alphas[ignore_mask] = 0
            example["label_distance_alphas"] = alphas
        else:
            example["label_distance_transform"] = distances
        return example
