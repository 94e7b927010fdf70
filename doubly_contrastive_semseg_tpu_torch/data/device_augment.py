"""Training augmentation on the device — port of the JAX package's
``data/device_augment.py``, the route of ``host_augment=False``: the host
only converts, and full-resolution batches become augmented crops here.

- ``RandomSquareCropAndScale`` (``custom_transforms_acdc.py:444-525``):
  scale ~ U(0.5, 2), a random square box, bicubic image resample with
  ``jax.image.scale_and_translate``'s rule (Keys cubic, no antialiasing),
  nearest labels, mean / ignore fill outside the frame;
- ``GammaCorrection`` (γ = 0.4 on night frames, ``:695-711``);
- ``LabelBoundaryTransform``'s EDT weights by the jump flood
  (``ops/edt.py``, the ``csrc/jfa.cu`` kernel on the card);
- ``TwoCropTransform``: two independent crops a sample, stacked [2B, ...].

JAX draws the crop parameters from ``jax.random`` keys and the port from a
``torch.Generator``, which give different numbers, so drawing
(``sample_crop_params``) and applying (``apply_augment``) are separate: the
tests feed JAX's drawn parameters to ``apply_augment``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.edt import label_boundary_weights
from ..parallel import rand_rows
from ..utils.profiling import span

MEAN_FILL = (73.15, 82.90, 72.3)
MIN_SCALE, MAX_SCALE = 0.5, 2.0


def sample_crop_params(generator: torch.Generator, b: int, h: int, w: int, crop: int,
                       two_crop: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x0, y0, box) float32, each (views, b) with views 2 or 1, on the
    generator's device, with the law of JAX ``_sample_crop_params``: scale
    ~ U(0.5, 2), box = ⌊scale · crop⌋ source pixels, and offsets
    ⌊u · (max(side − box, 0) + 1)⌋ for u ~ U(0, 1)."""
    dev = generator.device
    v = 2 if two_crop else 1
    # with several ranks, the global batch's draws, this rank's samples of them
    u = rand_rows((3, v, b), generator, dev, dim=2)
    scale = u[0] * (MAX_SCALE - MIN_SCALE) + MIN_SCALE
    box = torch.floor(scale * crop)
    max_x = torch.clamp(torch.clamp(box, min=w) - box, min=0)
    max_y = torch.clamp(torch.clamp(box, min=h) - box, min=0)
    return torch.floor(u[1] * (max_x + 1)), torch.floor(u[2] * (max_y + 1)), box


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel (a = −0.5) at |offset| x, as ``jax.image``
    evaluates it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _cubic_taps(in_size: int, crop: int, origin: torch.Tensor, s: torch.Tensor):
    """The 4 source taps of each output sample along one axis, for each of
    the (n,) crops with offset ``origin`` and scale ``s``: indices (n,
    crop, 4) clamped into the frame and float32 weights, by
    ``jax/_src/image/scale.py::compute_weight_mat``: sample centre
    ``(o + 0.5)/s − t/s − 0.5`` with t = −origin·s, taps |x| < 2 only, the
    weights normalised over the taps inside the frame, and all zero where
    the centre lies outside [−0.5, in − 0.5]."""
    dev = origin.device
    inv = 1.0 / s[:, None]
    t = (-origin * s)[:, None]
    o = torch.arange(crop, dtype=torch.float32, device=dev)[None, :]
    sample_f = (o + 0.5) * inv - t * inv - 0.5                       # (n, crop)
    first = torch.floor(sample_f) - 1.0
    idx = first[..., None] + torch.arange(4, dtype=torch.float32, device=dev)  # (n, crop, 4)
    inside = (idx >= 0) & (idx <= in_size - 1)
    weights = torch.where(inside, _keys_cubic(torch.abs(sample_f[..., None] - idx)), 0.0)
    total = weights.sum(-1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    in_range = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(in_range[..., None], weights, 0.0)
    return idx.clamp(0, in_size - 1).long(), weights


def crop_images(images: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                box: torch.Tensor, crop: int) -> torch.Tensor:
    """JAX ``_crop_image`` for a batch: the (y0, x0, box, box) window of
    each (B, H, W, 3) image resampled bicubically to (crop, crop), by 4-tap
    separable passes (columns, then rows) where JAX contracts dense weight
    matrices that are zero off those taps; then the mean colour where the
    output pixel's source centre lies outside the image, and a clip to
    [0, 255] as PIL's uint8 resize clamps. Returns (B, crop, crop, 3)
    float32."""
    b, h, w, _ = images.shape
    s = crop / box
    ix, wx = _cubic_taps(w, crop, x0, s)
    iy, wy = _cubic_taps(h, crop, y0, s)
    cols = torch.zeros((b, h, crop, 3), dtype=torch.float32, device=images.device)
    for k in range(4):
        g = torch.gather(images, 2, ix[:, None, :, k, None].expand(b, h, crop, 3))
        cols = cols + g.float() * wx[:, None, :, k, None]
    out = torch.zeros((b, crop, crop, 3), dtype=torch.float32, device=images.device)
    for k in range(4):
        g = torch.gather(cols, 1, iy[:, :, k, None, None].expand(b, crop, crop, 3))
        out = out + g * wy[:, :, k, None, None]
    o = torch.arange(crop, dtype=torch.float32, device=images.device)[None, :] + 0.5
    oy = o / s[:, None] + y0[:, None]
    ox = o / s[:, None] + x0[:, None]
    inside = (((oy >= 0) & (oy <= h))[:, :, None] & ((ox >= 0) & (ox <= w))[:, None, :])
    fill = torch.tensor(MEAN_FILL, dtype=torch.float32, device=images.device)
    out = torch.where(inside[..., None], out, fill)
    return torch.clamp(out, 0.0, 255.0)


def crop_labels(labels: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                box: torch.Tensor, crop: int, ignore_id: int = 255) -> torch.Tensor:
    """JAX ``_crop_label`` for a batch: the nearest source pixel
    ⌊y0 + i · (box / crop)⌋, computed in float32 in that order, and
    ``ignore_id`` outside the frame. (B, H, W) → (B, crop, crop), same
    dtype."""
    b, h, w = labels.shape
    step = (box / crop)[:, None]
    i = torch.arange(crop, dtype=torch.float32, device=labels.device)[None, :]
    ys = torch.floor(y0[:, None] + i * step).to(torch.int32)
    xs = torch.floor(x0[:, None] + i * step).to(torch.int32)
    valid = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    rows = ys.clamp(0, h - 1).long()[:, :, None].expand(b, crop, w)
    g = torch.gather(labels, 1, rows)
    g = torch.gather(g, 2, xs.clamp(0, w - 1).long()[:, None, :].expand(b, crop, crop))
    return torch.where(valid, g, torch.full_like(g, ignore_id))


def gamma_night(images: torch.Tensor, weather: torch.Tensor, gamma: float = 0.4) -> torch.Tensor:
    """γ-brighten the night frames (weather id 1), JAX ``_gamma_night``."""
    corrected = torch.clamp(images / 255.0, 0.0, 1.0) ** gamma * 255.0
    return torch.where((weather == 1).view(-1, 1, 1, 1), corrected, images)


def apply_augment(images: torch.Tensor, labels: torch.Tensor, weather: torch.Tensor,
                  params, crop: int = 768, num_classes: int = 19, two_crop: bool = True,
                  use_gamma: bool = False) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) raw frames → the training batch at crop resolution,
    JAX ``augment_batch`` given its crop parameters ``params`` = (x0, y0,
    box), each (views, B) (``sample_crop_params``): ``left`` (2B or B,
    crop, crop, 3) float32, ``label`` (B, crop, crop) and
    ``label_distance_weight`` (B, crop, crop) from view 0, ``weather``
    (B,). The ``dcss.augment`` span."""
    x0, y0, box = params

    def one_view(v):
        im = crop_images(images, x0[v], y0[v], box[v], crop)
        if use_gamma:
            im = gamma_night(im, weather)
        return im

    with span("dcss.augment"):
        lb0 = crop_labels(labels, x0[0], y0[0], box[0], crop)
        out: Dict[str, torch.Tensor] = {"weather": weather}
        out["left"] = torch.cat([one_view(0), one_view(1)], 0) if two_crop else one_view(0)
        out["label"] = lb0
        out["label_distance_weight"] = label_boundary_weights(lb0, num_classes)
    return out


def augment_batch(images: torch.Tensor, labels: torch.Tensor, weather: torch.Tensor,
                  generator: torch.Generator, crop: int = 768, num_classes: int = 19,
                  two_crop: bool = True, use_gamma: bool = False) -> Dict[str, torch.Tensor]:
    """``apply_augment`` with parameters drawn from ``generator``, which
    lies on the batch's device, so nothing leaves it."""
    b, h, w, _ = images.shape
    params = sample_crop_params(generator, b, h, w, crop, two_crop)
    return apply_augment(images, labels, weather, params, crop, num_classes, two_crop,
                         use_gamma)
